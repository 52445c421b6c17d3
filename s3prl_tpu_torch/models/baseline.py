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


class BaselineFeatures(nn.Module):
    """(wavs [B, T], wav_lens [B]) -> (feats [1, B, F, D], feat_lens [B]) on
    the device given: the parameter-free module keeps it in an empty buffer
    (`Upstream.device`), and the ops keep their tables there. ``cfg`` holds
    `baseline_features`' keywords; none is a dropout, so the upstream's
    train mode refuses nothing (`train_refusal`)."""

    def __init__(self, config_name: str = "fbank", device=None, **overrides):
        super().__init__()
        self.cfg = types.SimpleNamespace(**dict(BASELINE_CONFIGS[config_name], **overrides))
        self.stride = int(getattr(self.cfg, "frame_shift", 10.0) * SAMPLE_RATE / 1000)
        self.register_buffer("anchor", torch.empty(0, device=device), persistent=False)

    def forward(self, wavs: torch.Tensor, wav_lens: torch.Tensor):
        feats, feat_lens = baseline_features(wavs, wav_lens, **vars(self.cfg))
        return feats[None], feat_lens
