"""PaSST, the patchout spectrogram transformer in its HEAR form (port of
s3prl_tpu/models/passt.py).

The 16-kHz wave is resampled to 32 kHz by torchaudio's sinc_interp_hann
polyphase filter as one strided conv (`resample`, passt.py:108-144), cut
into 160-ms windows every 50 ms from a reflect-padded copy, and each window
runs the mel front end (`passt_mel`: pre-emphasis, a centred 800-point
symmetric Hann in a 1,024-point FFT, Kaldi mel banks up to 15 kHz,
(log(mel + 1e-5) + 4.5) / 5) and the net (`PasstNet`: a 16 x 16 patch conv
at stride 10 on the [F, T] plane, frequency and time position tables on
the floor-division grid, a cls token with its own position, ``depth``
pre-LN blocks at eps 1e-6, the final LN, then ``head_norm`` (eps 1e-5) and
Linear(527)); a window's embedding is [logits; cls features] (1,295). The
two-level variants concatenate a pass over windows ``two_level_mult`` times
as long, the ``*mel`` variants raw-mel timestamp embeddings (passt.py:
220-274). Stock ops: the blocks take eps 1e-6, which no kernel serves; the
resampler and the patch conv run in full f32 (TF32 off).
"""

from __future__ import annotations

import math
from dataclasses import dataclass

import numpy as np
import torch
import torch.nn as nn
import torch.nn.functional as F

from ..nn.heads import ieee_cudnn
from ..ops import audio
from ..ops.dtw import ieee_matmul
from .ast import patch_conv, run_blocks, vit_blocks
from .transformer import _layer_norm

SR_IN = 16000
SR_MODEL = 32000
# windows the net takes in one call: a bound on the attention's memory
# (the windows are independent, so the split changes no value)
WINDOWS_PER_CALL = 512


@dataclass(frozen=True)
class PasstConfig:
    """The field names and defaults of s3prl_tpu.models.passt.PasstConfig."""

    n_mels: int = 128
    n_fft: int = 1024
    win_length: int = 800
    mel_hop: int = 320
    fmin: float = 0.0
    fmax: float = 15000.0
    patch_size: int = 16
    fstride: int = 10
    tstride: int = 10
    embed_dim: int = 768
    depth: int = 12
    num_heads: int = 12
    mlp_ratio: float = 4.0
    n_classes: int = 527
    input_fdim: int = 128
    input_tdim: int = 998
    timestamp_window_ms: float = 160.0
    timestamp_hop_ms: float = 50.0
    two_level: bool = False
    two_level_mult: int = 5
    include_mel: bool = False
    mel_ts_window: int = 0

    @property
    def f_grid(self) -> int:
        return self.input_fdim // self.fstride

    @property
    def t_grid(self) -> int:
        return self.input_tdim // self.tstride

    @property
    def embedding_size(self) -> int:
        base = self.n_classes + self.embed_dim
        size = base * 2 if self.two_level else base
        if self.include_mel:
            size += self.n_mels * 6
        return size


PASST_BASE = PasstConfig()
PASST_HOP100 = PasstConfig(mel_hop=100, input_tdim=3200)
PASST_HOP160 = PasstConfig(mel_hop=160, input_tdim=2000)
PASST_20SEC = PasstConfig(input_tdim=2000)
PASST_30SEC = PasstConfig(input_tdim=3000)
PASST_2LVL = PasstConfig(two_level=True)
PASST_2LVL_MEL = PasstConfig(two_level=True, two_level_mult=4, include_mel=True,
                             mel_ts_window=1920)
PASST_HOP100_2LVL = PasstConfig(mel_hop=100, input_tdim=3200, two_level=True)
PASST_HOP100_2LVL_MEL = PasstConfig(mel_hop=100, input_tdim=3200, two_level=True,
                                    include_mel=True, mel_ts_window=600)
PASST_HOP160_2LVL = PasstConfig(mel_hop=160, input_tdim=2000, two_level=True)
PASST_HOP160_2LVL_MEL = PasstConfig(mel_hop=160, input_tdim=2000, two_level=True,
                                    include_mel=True, mel_ts_window=960)
# hub name -> configuration (s3prl_tpu/upstream/registry.py:1301-1375)
PASST_ENTRIES = {"passt_base": PASST_BASE, "passt_base2level": PASST_2LVL,
                 "passt_base20sec": PASST_20SEC, "passt_base30sec": PASST_30SEC,
                 "passt_hop100base": PASST_HOP100, "passt_hop160base": PASST_HOP160,
                 "passt_base2levelmel": PASST_2LVL_MEL, "passt_hop100base2lvl": PASST_HOP100_2LVL,
                 "passt_hop100base2lvlmel": PASST_HOP100_2LVL_MEL,
                 "passt_hop160base2lvl": PASST_HOP160_2LVL,
                 "passt_hop160base2lvlmel": PASST_HOP160_2LVL_MEL}


def resample_kernel(orig: int, new: int, lowpass_filter_width: int = 6,
                    rolloff: float = 0.99) -> np.ndarray:
    """torchaudio's sinc_interp_hann polyphase kernel [new, taps] for the
    reduced rates (a copy of passt.py:108-127)."""
    g = math.gcd(orig, new)
    orig, new = orig // g, new // g
    base_freq = min(orig, new) * rolloff
    width = math.ceil(lowpass_filter_width * orig / base_freq)
    idx = np.arange(-width, width + orig, dtype=np.float64) / orig
    t = np.arange(0, -new, -1, dtype=np.float64)[:, None] / new + idx[None]
    t *= base_freq
    t = np.clip(t, -lowpass_filter_width, lowpass_filter_width)
    window = np.cos(t * math.pi / lowpass_filter_width / 2) ** 2
    t *= math.pi
    kernels = np.where(t == 0, 1.0, np.sin(t) / np.where(t == 0, 1.0, t))
    kernels *= window * (base_freq / orig)
    return kernels.astype(np.float32)


def resample(wavs: torch.Tensor, orig: int = SR_IN, new: int = SR_MODEL) -> torch.Tensor:
    """[B, T] -> [B, ceil(T new / orig)]: one conv of stride orig (reduced)
    with a phase a channel, interleaved (passt.py:130-144)."""
    g = math.gcd(orig, new)
    o, n = orig // g, new // g
    kern = audio._on(resample_kernel, orig, new, device=wavs.device)  # [n, taps]
    width = (kern.shape[1] - o) // 2
    B, T = wavs.shape
    x = F.pad(wavs.float(), (width, width + o))
    with ieee_cudnn():
        out = F.conv1d(x[:, None], kern[:, None], stride=o)  # [B, n, frames]
    return out.transpose(1, 2).reshape(B, -1)[:, :math.ceil(T * n / o)]


def _mel_window(n_fft: int, win_length: int) -> np.ndarray:
    """torch.hann_window(win_length, periodic=False) centred in n_fft."""
    win = np.zeros(n_fft, np.float32)
    n = np.arange(win_length)
    start = (n_fft - win_length) // 2
    win[start:start + win_length] = (0.5 - 0.5 * np.cos(2 * np.pi * n / (win_length - 1))
                                     ).astype(np.float32)
    return win


def passt_mel(wavs32: torch.Tensor, cfg: PasstConfig) -> torch.Tensor:
    """AugmentMelSTFT's eval path (passt.py:147-167): [N, T] at 32 kHz ->
    [N, n_mels, frames]."""
    x = wavs32[:, 1:] - 0.97 * wavs32[:, :-1]
    xp = audio._reflect_pad(x, cfg.n_fft // 2)
    frames = audio.frame_wavs(xp, cfg.n_fft, cfg.mel_hop)
    win = audio._on(_mel_window, cfg.n_fft, cfg.win_length, device=x.device)
    spec = torch.fft.rfft(frames * win, dim=-1).abs() ** 2
    banks = audio._on(audio.kaldi_mel_banks, cfg.n_mels, cfg.n_fft, SR_MODEL,
                      max(cfg.fmin, 1e-8), cfg.fmax, device=x.device)
    with ieee_matmul():
        mel = torch.einsum("mf,btf->bmt", banks, spec)
    return (torch.log(mel + 1e-5) + 4.5) / 5.0


def windows(wav32: torch.Tensor, window: int, hop: int) -> torch.Tensor:
    """[B, T32] -> [B, n, window]: windows every `hop` samples of the wave
    reflect-padded by window // 2 on each side."""
    return audio._reflect_pad(wav32, window // 2).unfold(1, window, hop)


class PasstNet(nn.Module):
    """mel [N, F, T] -> (logits [N, n_classes], cls features [N, E])
    (passt.py:170-217). The conv's first kernel axis is frequency."""

    def __init__(self, cfg: PasstConfig = PASST_BASE, dtype: torch.dtype = torch.float32,
                 device=None):
        super().__init__()
        self.cfg, self.dtype = cfg, dtype
        E = cfg.embed_dim
        self.patch_embed = nn.Conv2d(1, E, cfg.patch_size, (cfg.fstride, cfg.tstride),
                                     device=device)
        self.freq_pos_embed = nn.Parameter(torch.empty(cfg.f_grid, E, device=device))
        self.time_pos_embed = nn.Parameter(torch.empty(cfg.t_grid, E, device=device))
        self.cls_token = nn.Parameter(torch.empty(1, 1, E, device=device))
        self.new_pos_embed = nn.Parameter(torch.empty(1, 1, E, device=device))
        self.blocks = vit_blocks(cfg, dtype, device)
        self.norm = nn.LayerNorm(E, eps=1e-6, device=device)
        self.head_norm = nn.LayerNorm(E, eps=1e-5, device=device)
        self.head = nn.Linear(E, cfg.n_classes, device=device)
        for m in (self.patch_embed, self.head):
            m.weight.data = m.weight.data.to(dtype)

    @torch.no_grad()
    def flax_init_(self, generator: torch.Generator) -> None:
        """flax's initialisers of the tables: normal(0.02), the cls token 0."""
        for p in (self.freq_pos_embed, self.time_pos_embed, self.new_pos_embed):
            p.copy_(torch.randn(p.shape, generator=generator) * 0.02)
        self.cls_token.zero_()

    def forward(self, mel: torch.Tensor):
        N, E = mel.shape[0], self.cfg.embed_dim
        x = patch_conv(self.patch_embed, mel[:, None].to(self.dtype))  # [N, E, F', T']
        Fp, Tp = x.shape[2], x.shape[3]
        x = x.permute(0, 2, 3, 1)
        x = x + self.freq_pos_embed[None, :Fp, None, :].to(x.dtype)
        x = x + self.time_pos_embed[None, None, :Tp, :].to(x.dtype)
        x = x.reshape(N, Fp * Tp, E)  # frequency-major, as torch's flatten(2)
        cls = (self.cls_token + self.new_pos_embed).to(x.dtype).expand(N, 1, E)
        x = run_blocks(self.blocks, torch.cat([cls, x], dim=1))
        feats = _layer_norm(x, self.norm)[:, 0]
        h = _layer_norm(feats, self.head_norm)
        logits = F.linear(h, self.head.weight, self.head.bias.to(h.dtype))
        return logits, feats


class PasstModel(nn.Module):
    """(wavs [B, T] at 16 kHz, wav_lens [B]) -> (embeddings [1, B, n_ts,
    embedding_size], lengths min(len * 2 // hop + 1, n_ts)), hop = 1,600
    samples at 32 kHz (passt.py:220-274). The net takes at most
    WINDOWS_PER_CALL windows a call."""

    def __init__(self, cfg: PasstConfig = PASST_BASE, dtype: torch.dtype = torch.float32,
                 device=None):
        super().__init__()
        self.cfg = cfg
        self.net = PasstNet(cfg, dtype, device)

    def _window_embeds(self, wav32: torch.Tensor, window: int, hop: int) -> torch.Tensor:
        segs = windows(wav32, window, hop)
        B, n = segs.shape[:2]
        out = []
        for part in segs.reshape(B * n, window).split(WINDOWS_PER_CALL):
            logits, feats = self.net(passt_mel(part, self.cfg))
            out.append(torch.cat([logits, feats], dim=-1))
        return torch.cat(out).reshape(B, n, -1)

    def forward(self, wavs: torch.Tensor, wav_lens: torch.Tensor, generator=None):
        cfg = self.cfg
        wav32 = resample(wavs)
        window = int(cfg.timestamp_window_ms * SR_MODEL / 1000)
        hop = int(cfg.timestamp_hop_ms * SR_MODEL / 1000)
        emb = self._window_embeds(wav32, window, hop)
        if cfg.two_level:  # a pass over mult x longer windows (passt.py:257-262)
            emb2 = self._window_embeds(wav32, window * cfg.two_level_mult, hop)
            n = min(emb.shape[1], emb2.shape[1])
            emb = torch.cat([emb[:, :n], emb2[:, :n]], dim=-1)
        if cfg.include_mel:  # the raw-mel timestamp embeddings (passt.py:263-272)
            segs = windows(wav32, cfg.mel_ts_window, hop)
            B, n_mel = segs.shape[:2]
            mel = passt_mel(segs.reshape(B * n_mel, -1), cfg).reshape(B, n_mel, -1)
            n = min(emb.shape[1], n_mel)
            emb = torch.cat([emb[:, :n], mel[:, :n].to(emb.dtype)], dim=-1)
        return emb[None], torch.clamp(wav_lens * 2 // hop + 1, max=emb.shape[1])
