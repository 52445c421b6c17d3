"""The port's multichip dry run (`s3prl_tpu_torch.parallel.dryrun`) on the
CPU: `dryrun_multichip(2)` (dp = 1 x tp = 2) and `(4)` (dp = 2 x tp = 2)
over spawned gloo ranks, one fwd + bwd + Adam step of the JAX dry run's
4-layer x 256 trunk + Featurizer + UtteranceLevel(4, (32,)) on its stock
path. The 4-rank step's loss and updated weights (the tp ranks' shards of
q, k, v, out_proj, fc1 and fc2 put back together) equal one process's
step on the same global batch: loss at rtol 1e-5, weights at max abs
5e-4 (tests/test_mesh_training.py:181-190's bound).
"""

import numpy as np
import pytest
import torch

from s3prl_tpu_torch.parallel import dryrun
from s3prl_tpu_torch.parallel.mesh import tp_rule


@pytest.fixture(scope="module")
def runs():
    return {n: dryrun.dryrun_multichip(n, threads=1) for n in (2, 4)}


def test_dryrun_multichip_two_ranks(runs):
    """dp = 1 x tp = 2: a finite loss, the same on both ranks, and each
    rank's layers hold two of the four heads."""
    (loss0, state0), (loss1, state1) = runs[2]
    assert np.isfinite(loss0) and loss0 == loss1
    assert state0["trunk.encoder.layers.0.self_attn.q_proj.weight"].shape == (128, 256)
    assert not torch.equal(state0["trunk.encoder.layers.0.fc1.weight"],
                           state1["trunk.encoder.layers.0.fc1.weight"])


def test_dryrun_multichip_four_ranks_matches_one_process(runs):
    """dp = 2 x tp = 2 against one process on the same 4-row batch: the
    loss and every updated weight."""
    loss, state = dryrun.run(1, "cpu", B=4)
    out = runs[4]
    for rank_loss, _ in out:
        np.testing.assert_allclose(rank_loss, loss, rtol=1e-5)
    for k, want in state.items():
        dim = tp_rule(k)
        for dp in range(2):  # ranks (2 dp, 2 tp): 0, 1 then 2, 3
            parts = [out[2 * dp + t][1][k] for t in range(2)]
            got = parts[0] if dim is None else torch.cat(parts, dim)
            assert float((got - want).abs().max()) <= 5e-4, k
            if dim is None:
                assert torch.equal(parts[0], parts[1]), k
