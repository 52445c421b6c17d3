"""The six baseline front ends of s3prl_tpu_torch (`fbank`, `fbank_no_cmvn`,
`mfcc`, `spectrogram`, `mel`, `linear`) vs s3prl_tpu's through SUpstream
(CPU), on `test_torch_port_audio`'s padded batch, with its tolerances: the
quantile rule on the utterances with frames; the 300- and 1-sample rows,
where CMVN divides by a vanishing deviation, finite and within 1e-3 of the
row's largest magnitude.
"""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from s3prl_tpu.nn.upstream import SUpstream as JaxSUpstream
from s3prl_tpu_torch.models.baseline import BASELINE_CONFIGS
from s3prl_tpu_torch.nn.upstream import SUpstream
from test_torch_port_audio import DEGENERATE, LENS, _batch, quantile_rule


@pytest.mark.parametrize("name", list(BASELINE_CONFIGS))
def test_baseline_entries_match_jax(name):
    """SUpstream(name): [1, B, T', D] and the lengths of JAX's Upstream
    under the reference's length rules (stride 160, one layer), the same in
    train mode."""
    wavs = _batch()
    want, want_lens = JaxSUpstream(name)(jnp.asarray(wavs), jnp.asarray(LENS))
    sup = SUpstream(name, extra_conf={"device": "cpu"})
    got, got_lens = sup(torch.from_numpy(wavs), torch.from_numpy(LENS))
    assert sup.num_layers == 1 and sup.downsample_rates == [160]
    assert sup.hidden_sizes == [want.shape[-1]] and got.shape == want.shape == (1, 5, 100,
                                                                                 want.shape[-1])
    np.testing.assert_array_equal(got_lens.numpy(), np.asarray(want_lens))
    # parameter-free: train mode (a trainable upstream) computes the same
    assert torch.equal(sup(torch.from_numpy(wavs), torch.from_numpy(LENS), train=True)[0], got)
    got, want = got.numpy()[0], np.asarray(want)[0]
    quantile_rule(got[~DEGENERATE], want[~DEGENERATE], name)
    assert np.isfinite(got).all()
    for b in np.flatnonzero(DEGENERATE):
        scale = np.abs(want[b]).max()
        assert np.abs(got[b] - want[b]).max() <= 1e-3 * scale, (name, b)
