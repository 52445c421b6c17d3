"""ops/audio of s3prl_tpu_torch vs s3prl_tpu (CPU); the baseline front ends
built on it: test_torch_port_baseline.

Every function of ops/audio on one seeded padded batch of five utterances
(16,000, 9,731, 4,000, 300 and 1 samples, at 0.1 of unit scale, as speech
sits): the 300- and 1-sample ones have no Kaldi frame (under the 400-sample
window), so `_fill_tail_with_last_valid` fills them with frame 0 and `cmvn`
divides by max(n, 1) and max(n - 1, 1). The tables (windows, mel banks,
DCT, lifter, HTK mel) are the same numpy code and must be equal.

Tolerances:
- the log features (spectrogram, fbank, MFCC, log-mel; and the baseline
  entries of test_torch_port_baseline) by `tests/test_audio_ops.py`'s
  quantile rule: median absolute error < 1e-3, 99th percentile < 0.01,
  bins above the median within 5e-3 (f32 FFT rounding lands on near-floor
  bins, whose logs then differ);
- the entries' rows of the 300- and 1-sample utterances, where CMVN divides
  by a vanishing deviation (no Kaldi frame; one or two STFT frames) and the
  features reach 1e11: finite, and within 1e-3 of the row's largest
  magnitude (measured: at most 1.1e-4, `linear`'s 300-sample row;
  test_torch_port_baseline);
- everything else (frames, STFT, deltas and CMVN on the same input, the
  power spectrogram) at atol 1e-5 and rtol 1e-5;
- the iSTFT at atol 1e-5 wherever the window sum is at least 1e-2; in the
  last samples of a reconstruction cut short (frames fewer than the
  length asks for), where the window sum vanishes and dividing by it
  amplifies the FFT's rounding, |difference| x window sum <= 1e-6.
"""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from s3prl_tpu.ops import audio as jax_audio
from s3prl_tpu_torch.ops import audio

LENS = np.asarray([16000, 9731, 4000, 300, 1], np.int32)
DEGENERATE = LENS < 400  # no Kaldi frame; at most two STFT frames
LOG_FEATURES = ("spectrogram", "fbank", "mfcc", "log_mel")


def _batch(T=16000, seed=0):
    rng = np.random.RandomState(seed)
    return (rng.randn(len(LENS), T) * 0.1 * (np.arange(T) < LENS[:, None])).astype(np.float32)


def _np(x):
    return x.detach().numpy() if isinstance(x, torch.Tensor) else np.asarray(x)


def quantile_rule(got, want, what):
    err = np.abs(got - want)
    assert np.median(err) < 1e-3, (what, np.median(err))
    assert np.percentile(err, 99) < 0.01, (what, np.percentile(err, 99))
    strong = want > np.median(want)
    np.testing.assert_allclose(got[strong], want[strong], atol=5e-3, rtol=0, err_msg=what)


def close(got, want, what):
    np.testing.assert_allclose(_np(got), _np(want), atol=1e-5, rtol=1e-5, err_msg=what)


def test_tables_equal_jax():
    for fn, args in ((audio.feature_window, ("povey", 400)),
                     (audio.feature_window, ("hamming", 400)),
                     (audio.feature_window, ("blackman", 400)),
                     (audio.kaldi_mel_banks, (80, 512)), (audio.kaldi_mel_banks, (23, 512)),
                     (audio.kaldi_dct_matrix, (13, 23)), (audio._lifter_coeffs, (13, 22.0)),
                     (audio.mel_scale_matrix, (201, 80))):
        np.testing.assert_array_equal(fn(*args), getattr(jax_audio, fn.__name__)(*args))
    edges = np.asarray([*LENS, 399, 400, 559, 560], np.int32)
    for snip in (True, False):
        np.testing.assert_array_equal(
            audio.num_frames(torch.from_numpy(edges), 400, 160, snip).numpy(),
            np.asarray(jax_audio.num_frames(jnp.asarray(edges), 400, 160, snip)))


def test_frames_are_a_view_and_equal_jax():
    wavs = _batch()
    src = torch.from_numpy(wavs)
    got = audio.frame_wavs(src, 400, 160)
    assert got.shape == (5, 98, 400)
    assert got.untyped_storage().data_ptr() == src.untyped_storage().data_ptr()
    np.testing.assert_array_equal(got.numpy(), np.asarray(jax_audio.frame_wavs(
        jnp.asarray(wavs), 400, 160)))
    assert audio.frame_wavs(torch.zeros(2, 399), 400, 160).shape == (2, 0, 400)


@pytest.mark.parametrize("name", LOG_FEATURES)
def test_log_features_match_jax(name):
    """The padded batch: lengths equal (0 frames under 400 samples), the
    features by the quantile rule, padded frames holding the last valid
    frame (frame 0 for an utterance with none)."""
    wavs = _batch()
    kwargs = {"num_mel_bins": 80} if name == "fbank" else {}
    want, want_lens = getattr(jax_audio, name)(jnp.asarray(wavs), jnp.asarray(LENS), **kwargs)
    got, got_lens = getattr(audio, name)(torch.from_numpy(wavs), torch.from_numpy(LENS), **kwargs)
    np.testing.assert_array_equal(got_lens.numpy(), np.asarray(want_lens))
    assert got.dtype == torch.float32 and got.shape == want.shape
    quantile_rule(got.numpy(), np.asarray(want), name)
    if name != "log_mel":  # the Kaldi features fill the tail
        assert list(got_lens[DEGENERATE]) == [0, 0]
        for b, n in enumerate(got_lens.tolist()):
            last = got[b, max(n - 1, 0)]
            assert torch.equal(got[b, max(n, 1):], last.expand_as(got[b, max(n, 1):]))


def test_power_spectrogram_and_deltas_cmvn_match_jax():
    wavs = _batch()
    for power in (1.0, 2.0):
        want, want_lens = jax_audio.stft_spectrogram(jnp.asarray(wavs), jnp.asarray(LENS),
                                                     power=power)
        got, got_lens = audio.stft_spectrogram(torch.from_numpy(wavs), torch.from_numpy(LENS),
                                               power=power)
        np.testing.assert_array_equal(got_lens.numpy(), np.asarray(want_lens))
        close(got, want, f"stft_spectrogram power {power}")
    rng = np.random.RandomState(1)
    feats = rng.randn(5, 50, 13).astype(np.float32)
    lens = np.asarray([50, 20, 7, 1, 0], np.int32)
    close(audio.add_deltas(torch.from_numpy(feats)), jax_audio.add_deltas(jnp.asarray(feats)),
          "add_deltas")
    close(audio.compute_deltas(torch.from_numpy(feats), 9),
          jax_audio.compute_deltas(jnp.asarray(feats), 9), "compute_deltas 9")
    close(audio.cmvn(torch.from_numpy(feats)), jax_audio.cmvn(jnp.asarray(feats)), "cmvn")
    got = audio.cmvn(torch.from_numpy(feats), torch.from_numpy(lens)).numpy()
    want = np.asarray(jax_audio.cmvn(jnp.asarray(feats), jnp.asarray(lens)))
    # rows of 1 and 0 frames divide by eps = 1e-10: compare them relatively
    close(got[:3], want[:3], "cmvn with lengths")
    np.testing.assert_allclose(got[3:], want[3:], rtol=1e-5, atol=0)


@pytest.mark.parametrize("T", [16000, 100, 1])
def test_stft_complex_matches_jax(T):
    """1 + T // 160 frames of the reflect-padded waves; at T = 100 and 1
    the 256-sample pad is longer than the waves (numpy's repeated
    reflection; one sample repeats)."""
    wavs = _batch()[:, :T]
    want = np.asarray(jax_audio.stft_complex(jnp.asarray(wavs)))
    got = audio.stft_complex(torch.from_numpy(wavs))
    assert got.dtype == torch.complex64 and got.shape == want.shape == (5, 1 + T // 160, 257)
    close(got.real, want.real, "real")
    close(got.imag, want.imag, "imag")


def _istft_close(got, want, frames, what):
    norm = audio._ola_norm(512, 160, 400, frames)[256:256 + want.shape[1]]
    err = np.abs(got - want)
    assert np.all(err[:, norm >= 1e-2] <= 1e-5 + 1e-5 * np.abs(want[:, norm >= 1e-2])), what
    assert np.all(err * norm <= 1e-6), what


@pytest.mark.parametrize("frames,length", [(101, 16000), (101, None), (49, 12000), (49, 7936)])
def test_istft_round_trip_matches_jax(frames, length):
    """istft(stft_complex(x)) of the batch (101 frames of 16,000 samples),
    and of its first 49 frames (a stride-320 upstream's T' of a 1-s
    bucket): JAX's length, 256 + 160 (frames - 1) at most, even when
    `length` asks for more; the full round trip gives the waves back."""
    wavs = _batch()
    spec = jax_audio.stft_complex(jnp.asarray(wavs))[:, :frames]
    want = np.asarray(jax_audio.istft(spec, length=length))
    got = audio.istft(audio.stft_complex(torch.from_numpy(wavs))[:, :frames], length=length)
    assert got.shape == want.shape == (5, min(length or 10 ** 9, 256 + 160 * (frames - 1)))
    _istft_close(got.numpy(), want, frames, f"{frames} frames, length {length}")
    if frames == 101 and length == 16000:
        np.testing.assert_allclose(got.numpy(), wavs, atol=1e-6, rtol=0)
