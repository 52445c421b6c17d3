"""SeExample of s3prl_tpu_torch vs s3prl_tpu through `Problem.run` (CPU),
on its default upstream, fbank: both packages train on the port's fbank
states (the JAX recipe's upstream runs them through a host callback,
`_mirror`), the port's SepRNN starting from the JAX one's initial params;
dropout 0 (the packages' generators differ) and one BLSTM layer of 32 (the
default three of 256 cost the JAX trainer's compile time, not coverage).

Tolerances: the train losses at rtol 1e-5, each saved probe parameter by
`test_torch_port_frame_probe`'s rule, the test metrics (si_sdr, si_sdri,
stoi, pesq) at rtol 1e-4.
"""

import numpy as np
import pytest

import s3prl_tpu.problem.enhancement as jax_enhancement
from s3prl_tpu_torch.nn.upstream import SUpstream
from test_torch_port_frame_probe import results, run_both, same_training
from test_torch_port_speaker_recipes import _mirror


@pytest.fixture(scope="module")
def fbank_states():
    """(the JAX upstream on the port's fbank, the port's fbank on the CPU)."""
    port_up = SUpstream("fbank", extra_conf={"device": "cpu"}).upstream
    return _mirror(port_up), port_up


def test_se_example_matches_jax(tmp_path, fbank_states, monkeypatch):
    """SeExample's three stages on its default upstream, fbank: stage 0's
    noisy tones, four steps of the SepRNN mask head (AdamW 1e-3)
    with a valid pass every 2 steps (dev-best by PESQ), the test si_sdr,
    si_sdri, stoi and pesq."""
    config = run_both(tmp_path, fbank_states, "SeExample", monkeypatch, [jax_enhancement],
                      build_downstream={"dropout": 0.0, "num_layers": 1, "hidden_size": 32})
    assert config["build_upstream"] == {"name": "fbank"}
    same_training(tmp_path, 1e-3)
    got, want = results(tmp_path)
    assert set(got["test"]) == set(want["test"]) == {"loss", "si_sdr", "si_sdri", "stoi", "pesq"}
    for k, v in want["test"].items():
        np.testing.assert_allclose(got["test"][k], v, rtol=1e-4, err_msg=k)
