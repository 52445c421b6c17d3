"""SUPERB's speaker recipes of s3prl_tpu_torch vs s3prl_tpu (CPU), through
`Problem.run`: AsvExample (x-vector + AM-softmax, then the trials' EER /
minDCF), Ge2eExample (SAP head + GE2E on speaker-grouped batches) and
SdExample (the LSTM head + PIT on Kaldi-style chunks, then the DER and the
hypothesis RTTM); the Kaldi preparer's CSVs and labels; the eight recipes'
default configs (AmsoftmaxSegmentExample's segment evaluation:
test_torch_port_speaker_segment).

Both packages train on the states of the port's tiny trunk of
`test_torch_port_probe` (the JAX recipes' upstream runs it through a host
callback, `_mirror`), bit for bit the same, and the port's probe starts
from the JAX probe's initial params, task parameters included
(`test_torch_port_recipes`; SuperbSD builds its upstream in `_trainer`, so
the JAX recipe's SUpstream is patched). The two trunks agree to 5e-4
(`test_supstream_matches_jax`), and that is too far here: over the
x-vector's 2M weights, Adam's first updates (about lr x sign(g)) turn the
gradients within that distance of zero into lr-sized moves, 3% of
tdnn_0's weights after two updates of AsvExample.

Tolerances: EER, minDCF and DER equal, the RTTM and the preparer's files
byte for byte (the workspace prefix aside), losses at rtol 1e-5; the probe
parameters (the task's included) at atol 1e-6 but for at most 1 in 1,000
elements of a tensor, which stay within 2 lr an update
(`test_torch_port_asr_recipes`' rule: on the same states, measured 1 of
81,920 of tdnn_0's weights 3.7e-6 apart after two updates of 1e-4, a
gradient near Adam's eps). SAP's ``attn.bias`` and GE2E's ``ge2e_b`` are
held within 2 lr an update and no closer: each adds one value to every
logit of a softmax (over time; over the speakers), so its gradient is zero
but for rounding, and Adam scales each package's rounding to a move of up
to lr (measured: ge2e_b 4.8e-4 apart after two updates of 4e-4).
"""

import numpy as np
import pytest
import torch
import yaml
from flax import serialization

import jax
import jax.numpy as jnp

import s3prl_tpu.problem as jax_problem
import s3prl_tpu.problem.diarization as jax_diarization
import s3prl_tpu_torch.problem as port_problem
from s3prl_tpu.nn.upstream import SUpstream as JaxSUpstream
from s3prl_tpu.upstream.base import Upstream as JaxUpstream
from s3prl_tpu_torch.upstream.convert import probe_state_dict_from_jax
from test_torch_port_probe import _wrap, tiny_pair  # noqa: F401 (fixture)
from test_torch_port_asr_recipes import _close_probe
from test_torch_port_recipes import _run_both
from test_torch_port_train import _losses

# parameters whose gradient is zero but for rounding (module docstring)
SHIFTS = (".attn.bias", "ge2e_b")
RECIPES = ["SuperbASV", "AsvExample", "Voxceleb2GE2E", "Ge2eExample",
           "Voxceleb2AMSoftmaxSegment", "AmsoftmaxSegmentExample", "SuperbSD", "SdExample"]


def _mirror(port_up):
    """A JAX Upstream whose model is the port's trunk, run on the host by
    ``jax.pure_callback`` (so inside the JAX trainer's jitted step too);
    the JAX package's length rules apply around it as to any model."""
    def run(wavs, lens):
        with torch.no_grad():
            hs, n = port_up.model(torch.from_numpy(np.array(wavs)),
                                  torch.from_numpy(np.array(lens)).long())
        return hs.numpy(), n.numpy().astype(np.int32)

    def apply_fn(params, wavs, lens, train, rngs):
        hs, n = run(np.zeros(wavs.shape, np.float32), np.full(lens.shape, wavs.shape[1]))
        shapes = (jax.ShapeDtypeStruct(hs.shape, jnp.float32),
                  jax.ShapeDtypeStruct(n.shape, jnp.int32))
        return jax.pure_callback(run, shapes, wavs, lens)

    return JaxUpstream("tiny (the port's)", apply_fn, {}, port_up.num_layers,
                       port_up.hidden_size, port_up.downsample_rate)


@pytest.fixture(scope="module")
def same_states(tiny_pair):  # noqa: F811 (fixture)
    """(the JAX upstream on the port's trunk, the port's upstream)."""
    return _mirror(tiny_pair[1]), tiny_pair[1]


def _same_training(tmp_path, lr):
    """Train losses at rtol 1e-5; each saved step's probe parameters (the
    task's included) by `_close_probe` after its Adam updates of rate lr
    (batches of one micro-step each), SHIFTS within 2 lr an update (module
    docstring)."""
    np.testing.assert_allclose(_losses(tmp_path / "port" / "train"),
                               _losses(tmp_path / "jax" / "train"), rtol=1e-5)
    saved = sorted(d.name for d in (tmp_path / "jax" / "train").glob("step_*"))
    assert saved and saved == sorted(d.name for d in (tmp_path / "port" / "train").glob("step_*"))
    for d in saved + ["valid_best"]:
        jax_dir, port_dir = tmp_path / "jax" / "train" / d, tmp_path / "port" / "train" / d
        assert port_dir.exists() == jax_dir.exists(), d
        if not jax_dir.exists():
            continue
        want = probe_state_dict_from_jax(
            serialization.msgpack_restore((jax_dir / "params.msgpack").read_bytes()))
        got = torch.load(port_dir / "model.pt")
        assert got.keys() == want.keys()
        updates = int(torch.load(port_dir / "optimizer.pt")["count"])
        for k in want:
            if k.endswith(SHIFTS):
                assert np.abs(got[k].numpy() - want[k].numpy()).max() <= 2 * lr * updates, k
            else:
                _close_probe(got[k].numpy(), want[k].numpy(), lr, updates, f"{d} {k}")


def _results(tmp_path):
    want = yaml.safe_load((tmp_path / "jax" / "result.yaml").read_text())
    got = yaml.safe_load((tmp_path / "port" / "result.yaml").read_text())
    assert got.keys() == want.keys() == {"test"}
    return got["test"], want["test"]


def check_asv_recipe(tmp_path, same_states, name, task_keys, lr):
    """All four stages of recipe `name` in both packages (stage 3 embeds
    the test utterances and scores the trials)."""
    _run_both(tmp_path, same_states, name)
    assert (tmp_path / "port" / "trials.csv").read_text() == \
        (tmp_path / "jax" / "trials.csv").read_text()
    _same_training(tmp_path, lr)
    assert task_keys <= torch.load(tmp_path / "port" / "train" / "step_4" / "model.pt").keys()
    got, want = _results(tmp_path)
    assert got == want and set(got) == {"eer", "minDCF"}
    assert 0.0 <= got["eer"] <= 1.0 and 0.0 <= got["minDCF"]


@pytest.mark.parametrize("name,task_keys,lr", [
    ("AsvExample", {"am_weight"}, 1e-4), ("Ge2eExample", {"ge2e_w", "ge2e_b"}, 4e-4)])
def test_asv_recipe_matches_jax(tmp_path, same_states, name, task_keys, lr):
    """Stage 3 embeds the test utterances by batch."""
    check_asv_recipe(tmp_path, same_states, name, task_keys, lr)


def test_sd_recipe_matches_jax(tmp_path, same_states, monkeypatch):
    """SdExample's three stages: stage 0's CSVs and .npy labels (20 frames
    a chunk's second at 160 samples), the PIT training with a valid pass
    every 2 steps (valid_best by DER), the test DER and hyp.rttm."""
    monkeypatch.setattr(jax_diarization, "SUpstream",
                        lambda **kwargs: _wrap(JaxSUpstream, same_states[0], False))
    _run_both(tmp_path, same_states, "SdExample")
    jax_ws, port_ws = tmp_path / "jax", tmp_path / "port"
    for split in ("train", "valid", "test"):
        assert (port_ws / f"{split}.csv").read_text() == \
            (jax_ws / f"{split}.csv").read_text().replace(str(jax_ws), str(port_ws))
    labels = sorted(p.name for p in (jax_ws / "labels").glob("*.npy"))
    assert labels and labels == sorted(p.name for p in (port_ws / "labels").glob("*.npy"))
    for f in labels:
        a, b = np.load(jax_ws / "labels" / f), np.load(port_ws / "labels" / f)
        assert a.dtype == b.dtype and np.array_equal(a, b), f
    _same_training(tmp_path, 1e-4)
    got, want = _results(tmp_path)
    assert got["der"] == want["der"] and 0.0 < got["der"]
    np.testing.assert_allclose(got["loss"], want["loss"], rtol=1e-5)
    rttm = (port_ws / "rttm" / "hyp.rttm").read_bytes()
    assert rttm == (jax_ws / "rttm" / "hyp.rttm").read_bytes()


@pytest.mark.parametrize("name", RECIPES)
def test_default_config_matches_jax(name):
    """The eight recipes' defaults, key for key; the default upstream
    (fbank) is not ported and raises, naming Queue 1 item 8."""
    assert getattr(port_problem, name)().default_config() == \
        getattr(jax_problem, name)().default_config()
    if name in ("SuperbASV", "SuperbSD"):
        with pytest.raises(NotImplementedError, match="Queue 1 item 8"):
            getattr(port_problem, name)().build_upstream(name="fbank")
