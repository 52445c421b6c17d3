"""PASE+ encoder (port of s3prl_tpu/models/pase.py).

SincNet's 64 learnable band-pass filters (kernel 251, SAME), BatchNorm and
PReLU; seven blocks of Conv1d (flax's SAME padding at strides 10, 4, 2,
2, 1, 1, 1) + BatchNorm + PReLU, each with a dense skip (a Linear to 256);
a QRNN with fo-pooling (gates from a width-2 causal conv, c_t = f_t c_{t-1}
+ (1 - f_t) z_t, h_t = o_t c_t); the projection ``W`` to 256; the skips
mean-pooled to the output rate and summed with it. Nine states of width 256
(the seven skips, W's output, their sum) at a 160-sample hop, lengths
min(ceil(len / 160), T').

The QRNN's recurrence is linear, so it runs as a log-depth scan of affine
maps over time (`linear_scan`: ceil(log2 T) passes of whole-tensor ops, as
the JAX package's ``associative_scan``, whose summation tree differs). The
convolutions run in full f32 (TF32 off). BatchNorm follows flax: eval mode
normalises with the running statistics; train mode with the batch's
(biased, E[x^2] - E[x]^2, every frame of the padded batch) and updates
nothing, as the JAX entry throws its ``batch_stats`` update away
(registry.py:1135-1141). The module names follow the JAX tree's.
"""

from __future__ import annotations

import math
from dataclasses import dataclass
from typing import Sequence

import torch
import torch.nn as nn
import torch.nn.functional as F

from ..nn.heads import ieee_call


@dataclass(frozen=True)
class PaseConfig:
    """The field names and defaults of s3prl_tpu.models.pase.PaseConfig."""

    sinc_filters: int = 64
    sinc_kernel: int = 251
    sample_rate: int = 16000
    kwidths: Sequence[int] = (21, 11, 11, 11, 11, 11, 11)
    strides: Sequence[int] = (10, 4, 2, 2, 1, 1, 1)
    fmaps: Sequence[int] = (64, 128, 128, 256, 256, 512, 512)
    emb_dim: int = 256
    qrnn_hidden: int = 512
    qrnn_window: int = 2

    @property
    def stride(self) -> int:
        return math.prod(self.strides)


def mel_init_cutoffs(n: int, sr: int):
    """SincNet's mel-spaced initial (low_hz, band_hz) (pase.py:57-72), f32."""
    def hz_to_mel(hz):
        return 2595.0 * torch.log10(1.0 + hz / 700.0)

    mel = torch.linspace(float(hz_to_mel(torch.tensor(30.0))),
                         float(hz_to_mel(torch.tensor(sr / 2 - 100.0))), n + 1)
    hz = 700.0 * (10.0 ** (mel / 2595.0) - 1.0)
    return hz[:-1], hz[1:] - hz[:-1]


class SincConv(nn.Module):
    """[B, T] -> [B, T, filters]: band-pass taps built from the (low, band)
    cutoffs at every call (pase.py:75-115), one SAME conv."""

    def __init__(self, filters: int = 64, kernel: int = 251, sample_rate: int = 16000,
                 device=None):
        super().__init__()
        self.kernel, self.sample_rate = kernel, sample_rate
        self.low_hz = nn.Parameter(torch.empty(filters, device=device))
        self.band_hz = nn.Parameter(torch.empty(filters, device=device))

    @torch.no_grad()
    def flax_init_(self, generator=None) -> None:
        low, band = mel_init_cutoffs(self.low_hz.shape[0], self.sample_rate)
        self.low_hz.copy_(low)
        self.band_hz.copy_(band)

    def taps(self) -> torch.Tensor:
        """[filters, kernel]: Hamming-windowed 2 hi sinc(2 hi t) - 2 lo sinc(2
        lo t), divided by 2 (hi - lo) + 1e-8."""
        sr = float(self.sample_rate)
        low = self.low_hz.abs() / sr
        high = torch.clamp(low + self.band_hz.abs() / sr, 0.0, 0.5)
        half = (self.kernel - 1) // 2
        t = torch.arange(1, half + 1, dtype=torch.float32, device=low.device)
        lo, hi = low[:, None], high[:, None]
        right = (torch.sin(2 * math.pi * hi * t) - torch.sin(2 * math.pi * lo * t)) / (math.pi * t)
        right = right * (0.54 - 0.46 * torch.cos(2 * math.pi * (t + half) / self.kernel))
        center = 2 * (hi - lo)
        f = torch.cat([right.flip(-1), center, right], dim=-1)
        return f / (2 * (hi - lo) + 1e-8)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        y = F.conv1d(x[:, None], self.taps()[:, None], padding=(self.kernel - 1) // 2)
        return y.transpose(1, 2)


def _batch_norm(x: torch.Tensor, bn: nn.BatchNorm1d, training: bool) -> torch.Tensor:
    """flax BatchNorm over [B, T, C]: the running statistics in eval mode,
    the batch's (biased, E[x^2] - E[x]^2) in train mode, no update."""
    if training:
        mean = x.mean(dim=(0, 1))
        var = torch.clamp((x * x).mean(dim=(0, 1)) - mean * mean, min=0.0)
    else:
        mean, var = bn.running_mean, bn.running_var
    return (x - mean) * (torch.rsqrt(var + bn.eps) * bn.weight) + bn.bias


def _prelu(x: torch.Tensor, act: nn.PReLU) -> torch.Tensor:
    return torch.where(x >= 0, x, act.weight * x)


def flax_same_pads(length: int, kernel: int, stride: int):
    """flax's SAME padding of one axis: a total of max((ceil(L / s) - 1) s +
    k - L, 0), total // 2 before."""
    total = max((-(-length // stride) - 1) * stride + kernel - length, 0)
    return total // 2, total - total // 2


def linear_scan(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """c_t = a_t c_{t-1} + b_t along dim 1 from c_{-1} = 0, by doubling
    (Hillis-Steele): after the pass at distance d every (a_t, b_t) composes
    the 2d maps ending at t."""
    d, T = 1, a.shape[1]
    while d < T:
        b = torch.cat([b[:, :d], a[:, d:] * b[:, :-d] + b[:, d:]], dim=1)
        a = torch.cat([a[:, :d], a[:, d:] * a[:, :-d]], dim=1)
        d *= 2
    return b


class PaseBlock(nn.Module):
    def __init__(self, c_in: int, c_out: int, kernel: int, stride: int, device=None):
        super().__init__()
        self.conv = nn.Conv1d(c_in, c_out, kernel, stride, device=device)
        self.bn = nn.BatchNorm1d(c_out, eps=1e-5, momentum=0.01, device=device)
        self.act = nn.PReLU(1, 0.01, device=device)

    def forward(self, h: torch.Tensor) -> torch.Tensor:  # [B, T, C]
        k, s = self.conv.kernel_size[0], self.conv.stride[0]
        x = F.pad(h.transpose(1, 2), flax_same_pads(h.shape[1], k, s))
        x = F.conv1d(x, self.conv.weight, self.conv.bias, stride=s).transpose(1, 2)
        return _prelu(_batch_norm(x, self.bn, self.training), self.act)


class QRNN(nn.Module):
    """[B, T, C] -> [B, T, H] (pase.py:118-146)."""

    def __init__(self, c_in: int, hidden: int = 512, window: int = 2, device=None):
        super().__init__()
        self.window = window
        self.gates = nn.Conv1d(c_in, 3 * hidden, window, device=device)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        x = F.pad(x.transpose(1, 2), (self.window - 1, 0))
        gates = F.conv1d(x, self.gates.weight, self.gates.bias).transpose(1, 2)
        z, f, o = gates.chunk(3, dim=-1)
        f = torch.sigmoid(f)
        return torch.sigmoid(o) * linear_scan(f, (1.0 - f) * torch.tanh(z))


class PaseModel(nn.Module):
    """(wavs [B, T], wav_lens [B]) -> (hidden states [9, B, T', 256] in the
    model dtype, lengths min(ceil(len / 160), T')) (pase.py:149-199)."""

    def __init__(self, cfg: PaseConfig = PaseConfig(), dtype: torch.dtype = torch.float32,
                 device=None):
        super().__init__()
        self.cfg, self.dtype = cfg, dtype
        self.sinc = SincConv(cfg.sinc_filters, cfg.sinc_kernel, cfg.sample_rate, device)
        self.sinc_bn = nn.BatchNorm1d(cfg.sinc_filters, eps=1e-5, momentum=0.01, device=device)
        self.sinc_act = nn.PReLU(1, 0.01, device=device)
        c_in = (cfg.sinc_filters,) + tuple(cfg.fmaps)
        self.blocks = nn.ModuleList(
            PaseBlock(c, fm, k, s, device)
            for c, fm, k, s in zip(c_in, cfg.fmaps, cfg.kwidths, cfg.strides))
        self.denseskips = nn.ModuleList(nn.Linear(fm, cfg.emb_dim, device=device)
                                        for fm in cfg.fmaps)
        self.qrnn = QRNN(cfg.fmaps[-1], cfg.qrnn_hidden, cfg.qrnn_window, device)
        self.W = nn.Linear(cfg.qrnn_hidden, cfg.emb_dim, device=device)

    def _states(self, wavs: torch.Tensor) -> torch.Tensor:
        h = _prelu(_batch_norm(self.sinc(wavs.float()), self.sinc_bn, self.training),
                   self.sinc_act)
        skips = []
        for block, skip in zip(self.blocks, self.denseskips):
            h = block(h)
            skips.append(skip(h))
        w_out = self.W(self.qrnn(h))
        B, T_out, C = w_out.shape
        aligned = []
        for s in skips:  # mean-pooled to the output rate (pase.py:181-189)
            d = s.shape[1] // T_out
            if d > 1:
                s = s[:, :T_out * d].reshape(B, T_out, d, C).mean(2)
            aligned.append(s[:, :T_out])
        return torch.stack(aligned + [w_out, w_out + sum(aligned)])

    def forward(self, wavs: torch.Tensor, wav_lens: torch.Tensor, generator=None):
        hs = ieee_call(self._states, wavs, self.parameters())
        stride = self.cfg.stride
        lens = torch.clamp((wav_lens + stride - 1) // stride, max=hs.shape[2])
        return hs.to(self.dtype), lens
