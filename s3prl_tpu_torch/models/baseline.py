"""Baseline acoustic front-end upstreams: fbank, MFCC, spectrogram, mel and
linear (port of s3prl_tpu/models/baseline.py).

The reference's baseline upstream (s3prl/upstream/baseline/extracter.py +
its fbank.yaml / mfcc.yaml ...): Kaldi-style features, optional deltas and
per-utterance CMVN, served as a one-"layer" upstream whose stride is the
frame shift. Parameter-free: `BaselineFeatures` holds no weight, only the
device its features are computed on.
"""

from __future__ import annotations

import types

import torch
import torch.nn as nn

from ..nn.heads import Dense
from ..nn.specaug import specaug
from ..ops import audio

SAMPLE_RATE = 16000

# config name -> the keywords of the reference's yaml files
BASELINE_CONFIGS = {
    "fbank": dict(feat_type="fbank", num_mel_bins=80, delta_order=2, cmvn=True),
    "fbank_no_cmvn": dict(feat_type="fbank", num_mel_bins=80, delta_order=0, cmvn=False),
    "mfcc": dict(feat_type="mfcc", num_ceps=13, delta_order=2, cmvn=True),
    "spectrogram": dict(feat_type="spectrogram", delta_order=0, cmvn=True),
    "mel": dict(feat_type="mel", n_mels=80, delta_order=0, cmvn=True),
    "linear": dict(feat_type="linear", delta_order=0, cmvn=True),
}


def baseline_features(
    wavs: torch.Tensor,
    wav_lens: torch.Tensor,
    *,
    feat_type: str = "fbank",
    num_mel_bins: int = 80,
    num_ceps: int = 13,
    n_mels: int = 80,
    frame_length: float = 25.0,
    frame_shift: float = 10.0,
    delta_order: int = 0,
    delta_win_length: int = 5,
    cmvn: bool = True,
):
    """Returns (feats [B, F, D] f32, feat_lens [B])."""
    if feat_type == "fbank":
        feats, feat_lens = audio.fbank(
            wavs, wav_lens, num_mel_bins=num_mel_bins,
            frame_length=frame_length, frame_shift=frame_shift,
        )
    elif feat_type == "mfcc":
        feats, feat_lens = audio.mfcc(
            wavs, wav_lens, num_ceps=num_ceps,
            frame_length=frame_length, frame_shift=frame_shift,
        )
    elif feat_type == "spectrogram":
        feats, feat_lens = audio.spectrogram(
            wavs, wav_lens, frame_length=frame_length, frame_shift=frame_shift
        )
    elif feat_type == "mel":
        feats, feat_lens = audio.log_mel(wavs, wav_lens, n_mels=n_mels)
    elif feat_type == "linear":
        spec, feat_lens = audio.stft_spectrogram(wavs, wav_lens)
        feats = torch.log(spec + 1e-10)
    else:
        raise ValueError(f"unknown feat_type {feat_type}")

    if delta_order > 0:
        feats = audio.add_deltas(feats, delta_order, delta_win_length)
    if cmvn:
        feats = audio.cmvn(feats, feat_lens)
    return feats, feat_lens


def mel_ssl_features(wavs: torch.Tensor, wav_lens: torch.Tensor, kind: str):
    """The mel-domain SSL models' front end (s3prl_tpu/upstream/registry.py:
    321-333, models/mos.py:115-129): ``"fbank_delta"`` Kaldi fbank 80 + Δ + ΔΔ
    + CMVN (240 dims, Mockingjay), ``"mel"`` log-mel 80 + CMVN (TERA,
    AudioALBERT, APC, NPC). Returns (feats [B, F, D] f32, feat_lens [B])."""
    if kind == "fbank_delta":
        return baseline_features(wavs, wav_lens, feat_type="fbank", num_mel_bins=80,
                                 delta_order=2, cmvn=True)
    if kind != "mel":
        raise ValueError(f"unknown mel front end {kind!r}: 'fbank_delta' or 'mel'")
    feats, feat_lens = audio.log_mel(wavs, wav_lens, n_mels=80)
    return audio.cmvn(feats, feat_lens), feat_lens


class BaselineFeatures(nn.Module):
    """(wavs [B, T], wav_lens [B]) -> (feats [1, B, F, D], feat_lens [B]) on
    the device given: the parameter-free module keeps it in an empty buffer
    (`Upstream.device`), and the ops keep their tables there. ``cfg`` holds
    `baseline_features`' keywords; none is a dropout, so train mode
    computes the same features (a `generator` is taken and not read)."""

    def __init__(self, config_name: str = "fbank", device=None, **overrides):
        super().__init__()
        self.cfg = types.SimpleNamespace(**dict(BASELINE_CONFIGS[config_name], **overrides))
        self.stride = int(getattr(self.cfg, "frame_shift", 10.0) * SAMPLE_RATE / 1000)
        self.register_buffer("anchor", torch.empty(0, device=device), persistent=False)

    def forward(self, wavs: torch.Tensor, wav_lens: torch.Tensor, generator=None):
        feats, feat_lens = baseline_features(wavs, wav_lens, **vars(self.cfg))
        return feats[None], feat_lens


# -- the small front ends (s3prl_tpu/upstream/registry.py:603-690): each is
# one "layer"; the model's device is its parameter's or its empty buffer's


class _OnDevice(nn.Module):
    """A parameter-free front end: an empty buffer keeps its device, and
    ``cfg`` is empty (nothing for `train_refusal` to refuse; train mode
    computes the same output, a `generator` is taken and not read)."""

    def __init__(self, device=None):
        super().__init__()
        self.cfg = types.SimpleNamespace()
        self.register_buffer("anchor", torch.empty(0, device=device), persistent=False)


class WavPassthrough(_OnDevice):
    """``wav``: the waveform itself, (wavs [1, B, T, 1], wav_lens), stride 1."""

    def forward(self, wavs: torch.Tensor, wav_lens: torch.Tensor, generator=None):
        return wavs[None, :, :, None], wav_lens


class LogStft(_OnDevice):
    """``log_stft``: log(|STFT|^2 + 1e-10) of the 400-point centre-padded
    hann STFT, hop 160: [1, B, F, 201]."""

    def forward(self, wavs: torch.Tensor, wav_lens: torch.Tensor, generator=None):
        spec, feat_lens = audio.stft_spectrogram(wavs, wav_lens)
        return torch.log(spec + 1e-10)[None], feat_lens


class SpecAugmentFeatures(_OnDevice):
    """``spec_augment`` (registry.py:641-660, the reference's
    upstream/spec_augment): Kaldi fbank 80 + deltas of order 2 + CMVN (240
    dims, stride 160) as one "layer", [1, B, F, 240], masked in train mode
    only by `nn.specaug.specaug` (2 frequency bands of at most 27 bins, 2
    time bands of at most 100 frames, inside each utterance's frames). The
    draws come from the forward's `generator` (a train step's upstream
    stream) or, without one, from a generator on the features' device
    seeded with ``seed`` at every call, so every call draws the same bands
    (the JAX entry's ``key(seed)``)."""

    def __init__(self, seed: int = 0, device=None):
        super().__init__(device)
        self.seed = seed  # a plain attribute, not state

    def forward(self, wavs: torch.Tensor, wav_lens: torch.Tensor, generator=None):
        feats, feat_lens = baseline_features(wavs, wav_lens, **BASELINE_CONFIGS["fbank"])
        if self.training:
            if generator is None:
                generator = torch.Generator(device=feats.device).manual_seed(self.seed)
            feats = specaug(generator, feats, feat_lens)
        return feats[None], feat_lens


class ExampleModel(nn.Module):
    """``example``, the reference's contributor template: Dense(64) over
    log-mel 80 (`audio.log_mel`), [1, B, F, 64]."""

    def __init__(self, device=None):
        super().__init__()
        self.cfg = types.SimpleNamespace()
        self.linear = Dense(80, 64, device=device)

    def forward(self, wavs: torch.Tensor, wav_lens: torch.Tensor, generator=None):
        mel, feat_lens = audio.log_mel(wavs, wav_lens, n_mels=80)
        return self.linear(mel)[None], feat_lens
