"""SUPERB-SG's separation in s3prl_tpu_torch vs s3prl_tpu (CPU):
SeparationTask with two sources at a stride-320 upstream's rate (51
frames of a 1-s bucket) against the JAX task with the same head weights,
by `test_torch_port_enhancement.task_matches_jax` (PIT: a row with its
sources swapped takes the other permutation, a row of two equal sources
ties and both packages take the first), and the JAX package's frame-rate
defect, which the port copies. Tolerances: those of
test_torch_port_enhancement.
"""

import types

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

import s3prl_tpu.problem as jax_problem
import s3prl_tpu_torch.problem as port_problem
from s3prl_tpu_torch.upstream.convert import probe_state_dict_from_jax
from test_torch_port_enhancement import B, KEY, LENS, task_batch, task_matches_jax
from test_torch_port_probe import tiny_pair  # noqa: F401 (fixture)


def test_separation_task_matches_jax():
    task_matches_jax(2, 51)


def test_frame_rate_defect_is_copied(tiny_pair):  # noqa: F811 (fixture)
    """The JAX package's defect, copied: with a stride-320 upstream the
    masks cover T' frames of a 1-s bucket, the reconstruction is 256 + 160
    (T' - 1) samples in both packages, and scoring a 12,000-sample
    utterance raises numpy's broadcast ValueError in both, with the same
    message (ROADMAP.md Queue 3)."""
    jax_up, port_up = tiny_pair
    batch = task_batch(1, 51)[2]
    hs_j, lens_j = jax.jit(lambda w, n: jax_up(w, n))(jnp.asarray(batch["x"]), jnp.asarray(LENS))
    hs, lens = port_up(torch.from_numpy(batch["x"]), torch.from_numpy(LENS))
    assert hs.shape[2] == hs_j.shape[2] and port_up.downsample_rate == 320
    Tp = hs.shape[2]
    # one set of head weights over the tiny trunk's 3 layers of 128
    up = types.SimpleNamespace(num_layers=hs.shape[0], hidden_sizes=[hs.shape[-1]] * hs.shape[0])
    config = jax_problem.SuperbSE().default_config()
    config["build_downstream"] = {"hidden_size": 16, "num_layers": 1, "dropout": 0.0}
    jax_task = jax_problem.SuperbSE().build_task(up, config)
    task = port_problem.SuperbSE().build_task(up, config)
    params = jax.jit(lambda k: jax_task.init_params(k, hs_j, lens_j, batch))(KEY)
    task.module.load_state_dict(probe_state_dict_from_jax(params))
    jbatch = {k: jnp.asarray(v) for k, v in batch.items()}
    _, want = jax.jit(lambda p: jax_task.loss_and_cache(p, hs_j, lens_j, jbatch, KEY,
                                                        False))(params)
    with torch.no_grad():
        _, got = task.loss_and_cache(hs, lens, batch, None, False)
    length = 256 + 160 * (Tp - 1)
    assert got["est_wav"].shape == np.shape(want["est_wav"]) == (B, 1, length) and length < 12000
    errors = []
    for reduce, cache in ((jax_task.reduction, want), (task.reduction, got)):
        record = {k: np.asarray(v) for k, v in cache.items()}
        with pytest.raises(ValueError, match="could not be broadcast") as err:
            reduce("test", [record])
        errors.append(str(err.value))
    assert errors[0] == errors[1] and f"({length},)" in errors[0]
