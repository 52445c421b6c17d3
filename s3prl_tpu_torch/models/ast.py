"""AST / SSAST / MAE-AST spectrogram patch and frame transformers (port of
s3prl_tpu/models/ast.py).

The wave's 128-bin Kaldi fbank (10-ms shift) is cut into 100-frame windows,
the last one zero-padded (ast.py:100-118); each window is patchified by a
(tshape x fshape) conv at stride (tstride, fstride) on its [T, F] plane
(16 x 16 at 10 for the patch models, 2 x 128 at (2, 128) for the frame
models), gets a cls token and learned positions, and runs ``depth`` pre-LN
ViT blocks at eps 1e-6 (`EncoderLayer`, stock ops: no kernel takes eps
1e-6); the final LN replaces the last state. A state drops the cls token
and averages the frequency patches; the windows' states are concatenated
in time: [depth + 1, B, W * tp, D], stride 160 * tstride. Matrix weights in
the model dtype (f32 or bf16), norms and the cls / position tables in f32
cast at use; the patch conv runs in full f32 (TF32 off) in an f32 model.
"""

from __future__ import annotations

from dataclasses import dataclass

import torch
import torch.nn as nn
import torch.nn.functional as F

from ..nn.heads import ieee_call
from ..ops import audio
from .transformer import EncoderLayer, _layer_norm


@dataclass(frozen=True)
class ASTConfig:
    """The field names and defaults of s3prl_tpu.models.ast.ASTConfig."""

    fshape: int = 16
    tshape: int = 16
    fstride: int = 10
    tstride: int = 10
    input_fdim: int = 128
    input_tdim: int = 100  # frames a window (1 s)
    embed_dim: int = 768
    depth: int = 12
    num_heads: int = 12
    mlp_ratio: float = 4.0

    @property
    def f_patches(self) -> int:
        return (self.input_fdim - self.fshape) // self.fstride + 1

    @property
    def t_patches(self) -> int:
        return (self.input_tdim - self.tshape) // self.tstride + 1


SSAST_PATCH = ASTConfig()
SSAST_FRAME = ASTConfig(fshape=128, tshape=2, fstride=128, tstride=2)


def vit_blocks(cfg, dtype: torch.dtype, device=None) -> nn.ModuleList:
    """``depth`` timm ViT blocks as pre-LN `EncoderLayer`s at eps 1e-6 with
    erf GELU (the JAX package's EncoderLayer(layer_norm_first=True,
    layer_norm_eps=1e-6)), on stock ops."""
    return nn.ModuleList(
        EncoderLayer(cfg.embed_dim, int(cfg.embed_dim * cfg.mlp_ratio), cfg.num_heads, dtype,
                     layer_norm_eps=1e-6, device=device, layer_norm_first=True)
        for _ in range(cfg.depth))


def run_blocks(blocks: nn.ModuleList, x: torch.Tensor, states: list | None = None
               ) -> torch.Tensor:
    """x [N, T, C] through `blocks` with no padding (every token attends to
    every token), each block's output appended to `states` when given."""
    N, T, _ = x.shape
    kv_lens = torch.full((N,), T, dtype=torch.int32, device=x.device)
    pad = torch.zeros(N, T, dtype=torch.bool, device=x.device)
    for block in blocks:
        x = block(x, kv_lens, pad)
        if states is not None:
            states.append(x)
    return x


def patch_conv(conv: nn.Conv2d, x: torch.Tensor) -> torch.Tensor:
    """The patch embedding: a VALID strided conv with the weight and bias
    cast to x's dtype (flax's ``nn.Conv(dtype=...)``), cuDNN in full f32
    for an f32 x."""
    def run(y):
        return F.conv2d(y, conv.weight.to(y.dtype), conv.bias.to(y.dtype), stride=conv.stride)

    return ieee_call(run, x, [conv.weight, conv.bias])


class ASTEncoder(nn.Module):
    """One window: fbank [N, input_tdim, input_fdim] -> hidden states
    [depth + 1, N, tp, D] (ast.py:49-97)."""

    def __init__(self, cfg: ASTConfig = SSAST_PATCH, dtype: torch.dtype = torch.float32,
                 device=None):
        super().__init__()
        self.cfg, self.dtype = cfg, dtype
        D = cfg.embed_dim
        # applied to [N, 1, T, F]: the kernel's first axis is time (ast.py:57-64)
        self.patch_embed = nn.Conv2d(1, D, (cfg.tshape, cfg.fshape), (cfg.tstride, cfg.fstride),
                                     device=device)
        self.patch_embed.weight.data = self.patch_embed.weight.data.to(dtype)
        self.cls_token = nn.Parameter(torch.empty(1, 1, D, device=device))
        self.pos_embed = nn.Parameter(
            torch.empty(1, cfg.t_patches * cfg.f_patches + 1, D, device=device))
        self.blocks = vit_blocks(cfg, dtype, device)
        self.norm = nn.LayerNorm(D, eps=1e-6, device=device)

    @torch.no_grad()
    def flax_init_(self, generator: torch.Generator) -> None:
        """flax's normal(0.02) for the cls token and the positions."""
        for p in (self.cls_token, self.pos_embed):
            p.copy_(torch.randn(p.shape, generator=generator) * 0.02)

    def forward(self, fbank: torch.Tensor) -> torch.Tensor:
        cfg, N, D = self.cfg, fbank.shape[0], self.cfg.embed_dim
        x = patch_conv(self.patch_embed, fbank[:, None].to(self.dtype))  # [N, D, tp, fp]
        tp, fp = x.shape[2], x.shape[3]
        x = x.permute(0, 2, 3, 1).reshape(N, tp * fp, D)
        cls = self.cls_token.to(x.dtype).expand(N, 1, D)
        x = torch.cat([cls, x], dim=1) + self.pos_embed.to(x.dtype)
        states = [x]
        x = run_blocks(self.blocks, x, states)
        states[-1] = _layer_norm(x, self.norm)
        hs = torch.stack(states)[:, :, 1:]  # the cls token dropped
        return hs.reshape(len(states), N, tp, fp, D).mean(3)


class ASTModel(nn.Module):
    """(wavs [B, T], wav_lens [B]) -> (hidden states [depth + 1, B, W * tp,
    D], lengths min(max((len - 1) // (160 tstride) + 1, 1), W * tp))
    (ast.py:100-118): W = max(ceil(T' / input_tdim), 1) windows of the
    T'-frame fbank, the last zero-padded."""

    def __init__(self, cfg: ASTConfig = SSAST_PATCH, dtype: torch.dtype = torch.float32,
                 device=None):
        super().__init__()
        self.cfg = cfg
        self.encoder = ASTEncoder(cfg, dtype, device)

    def forward(self, wavs: torch.Tensor, wav_lens: torch.Tensor, generator=None):
        cfg = self.cfg
        fbank, _ = audio.fbank(wavs, wav_lens, num_mel_bins=cfg.input_fdim, frame_shift=10.0)
        B, T, Fd = fbank.shape
        W = max(-(-T // cfg.input_tdim), 1)
        fbank = F.pad(fbank, (0, 0, 0, W * cfg.input_tdim - T))
        hs = self.encoder(fbank.reshape(B * W, cfg.input_tdim, Fd))
        L, _, tp, D = hs.shape
        lens = torch.clamp((wav_lens - 1) // (160 * cfg.tstride) + 1, min=1)
        return hs.reshape(L, B, W * tp, D), torch.clamp(lens, max=W * tp)
