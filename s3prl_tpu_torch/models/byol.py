"""BYOL-A / BYOL-S: windowed audio embeddings (port of
s3prl_tpu/models/byol.py; the reference's byol_a/byol_a.py:89-140,
byol_a/expert.py:28-130 and byol_s/serab_byols).

Each utterance is cut into 1 s windows: BYOL-A's do not overlap and start
at 0 (the tail zero-padded), BYOL-S's start every 50 ms in the wave
zero-padded by half a window before and half after. Each window's log-mel
(torchaudio's MelSpectrogram: power 2, HTK mel 60-7,800 Hz, centre-reflect
STFT, then log(mel + f32 eps), on `ops.audio`) is normalised, BYOL-A's by
fixed statistics, BYOL-S's by the whole batch's: every window of every
row, padded ones included, with the reference's 1/N quirk and the
unbiased std. So a BYOL-S result depends on the batch, as in the JAX
package. A window encoder (`AudioNTT2020`, `ResNetish34` or `CvT`, on
[N, 1, mel, time]) then gives one embedding a window: hidden states
[1, B, windows, d].

Every BatchNorm runs on its running statistics, in train mode too (the
JAX package's ``use_running_average=True``): its buffers never change.
Train mode applies AudioNTT2020's dropout (0.3) only. The modules carry
the reference's keys under ``net.`` (``features.{i}`` / ``fc.{i}``,
torchvision-style ``conv1`` / ``layer{i}.{b}``, CvT's ``layers.{i}``).
f32 only; cuDNN with TF32 off (`ieee_call`).
"""

from __future__ import annotations

from dataclasses import dataclass

import numpy as np
import torch
import torch.nn as nn
import torch.nn.functional as F

from ..nn.heads import dropout, ieee_call
from ..ops import audio
from ..ops.dtw import ieee_matmul

SAMPLE_RATE = 16000
EPS = float(np.finfo(np.float32).eps)


@dataclass(frozen=True)
class ByolConfig:
    """The JAX package's fields and defaults (its ``ByolConfig``)."""

    n_mels: int = 64
    feature_d: int = 2048
    n_fft: int = 1024
    win_length: int = 1024  # byol_s uses 400
    hop_length: int = 160
    f_min: float = 60.0
    f_max: float = 7800.0
    window_secs: float = 1.0
    stride_secs: float = 1.0  # byol_s: 0.05
    norm_stats: tuple = (-5.4919195, 5.0389895)
    batch_norm_stats: bool = False
    encoder: str = "ntt"  # "ntt" | "resnetish34" | "cvt"


BYOL_A_2048 = ByolConfig()
BYOL_A_1024 = ByolConfig(feature_d=1024)
BYOL_A_512 = ByolConfig(feature_d=512)
BYOL_S_DEFAULT = ByolConfig(win_length=400, stride_secs=0.05, batch_norm_stats=True)
BYOL_S_RESNETISH34 = ByolConfig(win_length=400, stride_secs=0.05, batch_norm_stats=True,
                                encoder="resnetish34")
BYOL_S_CVT = ByolConfig(win_length=400, stride_secs=0.05, batch_norm_stats=True, encoder="cvt")


def batch_norm(x: torch.Tensor, bn: nn.BatchNorm2d) -> torch.Tensor:
    """bn on its running statistics, whatever the module's mode."""
    return F.batch_norm(x, bn.running_mean, bn.running_var, bn.weight, bn.bias, False, 0.0,
                        bn.eps)


def mean_max_over_time(x: torch.Tensor) -> torch.Tensor:
    """[N, C, F, T] -> [N, F * C]: each frame's (mel, channel) features
    flattened mel-major, then their mean plus their max over time."""
    x = x.permute(0, 3, 2, 1).flatten(2)
    return x.mean(1) + x.amax(1)


class AudioNTT2020(nn.Module):
    """Three conv 3x3 -> BatchNorm -> ReLU -> max-pool 2x2 blocks, then per
    frame Linear -> ReLU -> dropout -> Linear -> ReLU, then mean + max over
    time (byol.py:70-92)."""

    def __init__(self, n_mels: int = 64, d: int = 2048, device=None):
        super().__init__()
        layers = []
        for i in range(3):
            layers += [nn.Conv2d(1 if i == 0 else 64, 64, 3, padding=1, device=device),
                       nn.BatchNorm2d(64, device=device), nn.ReLU(), nn.MaxPool2d(2, 2)]
        self.features = nn.Sequential(*layers)
        self.fc = nn.Sequential(nn.Linear(64 * (n_mels // 8), d, device=device), nn.ReLU(),
                                nn.Dropout(0.3), nn.Linear(d, d, device=device), nn.ReLU())

    def forward(self, x: torch.Tensor, generator=None) -> torch.Tensor:  # [N, 1, F, T]
        for i in range(0, 12, 4):
            x = F.max_pool2d(F.relu(batch_norm(self.features[i](x), self.features[i + 1])), 2)
        x = x.permute(0, 3, 2, 1).flatten(2)
        x = dropout(F.relu(self.fc[0](x)), self.fc[2].p, self.training, generator)
        x = F.relu(self.fc[3](x))
        return x.mean(1) + x.amax(1)


class BasicBlock(nn.Module):
    """ResNet's BasicBlock (resnetish.py:56-105)."""

    def __init__(self, inplanes: int, planes: int, stride: int, downsample: bool, device=None):
        super().__init__()
        self.conv1 = nn.Conv2d(inplanes, planes, 3, stride, 1, bias=False, device=device)
        self.bn1 = nn.BatchNorm2d(planes, device=device)
        self.conv2 = nn.Conv2d(planes, planes, 3, 1, 1, bias=False, device=device)
        self.bn2 = nn.BatchNorm2d(planes, device=device)
        self.downsample = nn.Sequential(
            nn.Conv2d(inplanes, planes, 1, stride, bias=False, device=device),
            nn.BatchNorm2d(planes, device=device)) if downsample else None

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        y = F.relu(batch_norm(self.conv1(x), self.bn1))
        y = batch_norm(self.conv2(y), self.bn2)
        idt = x if self.downsample is None else batch_norm(self.downsample[0](x),
                                                            self.downsample[1])
        return F.relu(y + idt)


class ResNetish34(nn.Module):
    """The resnetish34 window encoder (resnetish.py:176-312, :384-399): a
    7x7 stem at stride 1, max-pool 3x3 / 2, BasicBlock stages [3, 4, 6, 3],
    then mean + max over time."""

    STAGES = ((64, 3, 1), (128, 4, 2), (256, 6, 2), (512, 3, 2))  # (planes, blocks, stride)

    def __init__(self, device=None):
        super().__init__()
        self.conv1 = nn.Conv2d(1, 64, 7, 1, 3, bias=False, device=device)
        self.bn1 = nn.BatchNorm2d(64, device=device)
        inplanes = 64
        for li, (planes, blocks, stride) in enumerate(self.STAGES):
            layer = []
            for b in range(blocks):
                s = stride if b == 0 else 1
                layer.append(BasicBlock(inplanes, planes, s,
                                        b == 0 and (s != 1 or inplanes != planes), device))
                inplanes = planes
            self.add_module(f"layer{li + 1}", nn.Sequential(*layer))

    def forward(self, x: torch.Tensor, generator=None) -> torch.Tensor:
        x = F.max_pool2d(F.relu(batch_norm(self.conv1(x), self.bn1)), 3, 2, 1)
        for li in range(len(self.STAGES)):
            x = getattr(self, f"layer{li + 1}")(x)
        return mean_max_over_time(x)


class CvtLayerNorm(nn.Module):
    """CvT's channel LayerNorm (cvt.py:40-53): the biased std, eps added to
    the std; g and b [1, C, 1, 1]."""

    def __init__(self, dim: int, device=None):
        super().__init__()
        self.g = nn.Parameter(torch.empty(1, dim, 1, 1, device=device))
        self.b = nn.Parameter(torch.empty(1, dim, 1, 1, device=device))

    @torch.no_grad()
    def reset_parameters(self, generator=None) -> None:
        self.g.fill_(1.0)
        self.b.zero_()

    def forward(self, x: torch.Tensor) -> torch.Tensor:  # [N, C, H, W]
        mean = x.mean(1, keepdim=True)
        std = (x - mean).square().mean(1, keepdim=True).sqrt()
        return (x - mean) / (std + 1e-5) * self.g + self.b


class DepthWiseConv2d(nn.Module):
    """A depthwise conv -> BatchNorm -> pointwise conv (cvt.py:86-105)."""

    def __init__(self, dim_in: int, dim_out: int, kernel: int, stride: int, bias: bool,
                 device=None):
        super().__init__()
        self.net = nn.Sequential(
            nn.Conv2d(dim_in, dim_in, kernel, stride, kernel // 2, groups=dim_in, bias=bias,
                      device=device),
            nn.BatchNorm2d(dim_in, device=device),
            nn.Conv2d(dim_in, dim_out, 1, bias=bias, device=device))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return self.net[2](batch_norm(self.net[0](x), self.net[1]))


class CvtAttention(nn.Module):
    """Attention over the (mel, time) grid with conv projections
    (cvt.py:108-152): q at stride 1, k and v at stride 2, 64 a head."""

    def __init__(self, dim: int, heads: int, dim_head: int = 64, device=None):
        super().__init__()
        self.heads, self.dim_head = heads, dim_head
        inner = heads * dim_head
        self.to_q = DepthWiseConv2d(dim, inner, 3, 1, False, device)
        self.to_kv = DepthWiseConv2d(dim, 2 * inner, 3, 2, False, device)
        self.to_out = nn.Sequential(nn.Conv2d(inner, dim, 1, device=device), nn.Dropout(0.0))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        q = self.to_q(x)
        k, v = self.to_kv(x).chunk(2, dim=1)
        N, _, H, W = q.shape

        def heads(t):  # [N, (h d), x, y] -> [N, h, (x y), d]
            return t.reshape(N, self.heads, self.dim_head, -1).transpose(2, 3)

        scores = (heads(q) @ heads(k).transpose(2, 3)) * self.dim_head ** -0.5
        out = scores.softmax(-1) @ heads(v)  # [N, h, HW, d]
        return self.to_out[0](out.transpose(2, 3).reshape(N, -1, H, W))


class CvtFeedForward(nn.Module):
    def __init__(self, dim: int, mult: int = 4, device=None):
        super().__init__()
        self.net = nn.Sequential(nn.Conv2d(dim, dim * mult, 1, device=device), nn.GELU(),
                                 nn.Dropout(0.0), nn.Conv2d(dim * mult, dim, 1, device=device),
                                 nn.Dropout(0.0))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return self.net[3](F.gelu(self.net[0](x)))


class PreNorm(nn.Module):
    def __init__(self, dim: int, fn: nn.Module, device=None):
        super().__init__()
        self.norm, self.fn = CvtLayerNorm(dim, device), fn

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return self.fn(self.norm(x))


class CvtTransformer(nn.Module):
    def __init__(self, dim: int, depth: int, heads: int, device=None):
        super().__init__()
        self.layers = nn.ModuleList(nn.ModuleList([
            PreNorm(dim, CvtAttention(dim, heads, device=device), device),
            PreNorm(dim, CvtFeedForward(dim, device=device), device)]) for _ in range(depth))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        for attn, ff in self.layers:
            x = x + attn(x)
            x = x + ff(x)
        return x


class CvT(nn.Module):
    """The CvT window encoder in serab_byols' shape (cvt.py:199-323): three
    stages of a strided conv embedding, LayerNorm and a transformer, then
    mean + max over time."""

    STAGES = ((64, 7, 4, 1, 1), (256, 3, 2, 3, 1), (512, 3, 2, 6, 1))
    # (dim, embedding kernel, embedding stride, heads, depth) a stage

    def __init__(self, device=None):
        super().__init__()
        stages, dim_in = [], 1
        for dim, k, s, heads, depth in self.STAGES:
            stages.append(nn.Sequential(nn.Conv2d(dim_in, dim, k, s, k // 2, device=device),
                                        CvtLayerNorm(dim, device),
                                        CvtTransformer(dim, depth, heads, device)))
            dim_in = dim
        self.layers = nn.Sequential(*stages)

    def forward(self, x: torch.Tensor, generator=None) -> torch.Tensor:
        return mean_max_over_time(self.layers(x))


def byol_embedding_size(cfg: ByolConfig) -> int:
    if cfg.encoder in ("resnetish34", "cvt"):
        return 512 * (cfg.n_mels // 16)  # 512 channels x n_mels / 16 bins
    return cfg.feature_d


def byol_encoder(cfg: ByolConfig, device=None) -> nn.Module:
    if cfg.encoder == "resnetish34":
        return ResNetish34(device)
    if cfg.encoder == "cvt":
        return CvT(device)
    if cfg.encoder != "ntt":
        raise ValueError(f"encoder {cfg.encoder!r}: 'ntt', 'resnetish34' or 'cvt'")
    return AudioNTT2020(cfg.n_mels, cfg.feature_d, device)


class ByolModel(nn.Module):
    """(wavs [B, T], wav_lens [B]) -> (hidden states [1, B, windows, d] f32,
    window counts [B]) (byol.py:273-325)."""

    def __init__(self, cfg: ByolConfig = BYOL_A_2048, device=None):
        super().__init__()
        self.cfg = cfg
        self.net = byol_encoder(cfg, device)

    def windows(self, wavs: torch.Tensor):
        """The windows [B, n, window] of each row and their count n."""
        cfg, T = self.cfg, wavs.shape[1]
        window = int(cfg.window_secs * SAMPLE_RATE)
        step = int(cfg.stride_secs * SAMPLE_RATE)
        if cfg.batch_norm_stats:  # frame_audio (utils.py:70-74)
            xp = F.pad(wavs, (window // 2, window - window // 2))
            n = T // step + 1
        else:  # from the start, the tail zero-padded (expert.py:84-91)
            n = len(range(0, T, step))
            xp = F.pad(wavs, (0, max((n - 1) * step + window - T, 0)))
        return xp.unfold(1, window, step)[:, :n], n

    def log_mel(self, segs: torch.Tensor) -> torch.Tensor:
        """[N, samples] -> log-mel [N, n_mels, frames] (byol.py:260-270)."""
        cfg = self.cfg
        spec, _ = audio.stft_spectrogram(segs, n_fft=cfg.n_fft, hop_length=cfg.hop_length,
                                         win_length=cfg.win_length, power=2.0)
        with ieee_matmul():
            mel = spec @ audio._on(audio.mel_scale_matrix, cfg.n_fft // 2 + 1, cfg.n_mels,
                                   SAMPLE_RATE, cfg.f_min, cfg.f_max, device=spec.device)
        return torch.log(mel + EPS).transpose(1, 2)

    def _states(self, wavs: torch.Tensor, generator) -> torch.Tensor:
        cfg = self.cfg
        segs, n = self.windows(wavs.float())
        mel = self.log_mel(segs.reshape(-1, segs.shape[-1]))
        if cfg.batch_norm_stats:  # the reference's 1/N quirk (utils.py:40-47)
            count = mel.shape[0]
            mel = (mel - mel.mean() / count) / (mel.std() / count)
        else:
            mean, std = cfg.norm_stats
            mel = (mel - mean) / std
        emb = self.net(mel[:, None], generator)
        return emb.reshape(wavs.shape[0], n, -1)[None]

    def forward(self, wavs: torch.Tensor, wav_lens: torch.Tensor, generator=None):
        cfg = self.cfg
        hs = ieee_call(lambda w: self._states(w, generator), wavs, self.parameters())
        step = int(cfg.stride_secs * SAMPLE_RATE)
        n = hs.shape[2]
        if cfg.batch_norm_stats:  # BYOL-S's centre-padded frames: l // step + 1
            lens = torch.div(wav_lens, step, rounding_mode="floor") + 1
        else:  # BYOL-A: an exact multiple of the stride counts no extra window
            lens = torch.div(wav_lens - 1, step, rounding_mode="floor") + 1
        return hs, lens.clamp(max=n)
