"""NPC: non-autoregressive predictive coding with masked convolutions (port
of s3prl_tpu/models/npc.py:24-121; the reference's npc/npc.py:21-260).

A stack of ConvBlocks (a k = 3 conv padded 1 a side, BatchNorm, the
activation, a 1 x 1 conv, BatchNorm, dropout, the residual from the second
block on, the activation), each followed by a MaskConvBlock whose kernel,
padded (k - 1) / 2 a side, has a zeroed centre band of ``mask_size + 2``
frames growing by 2 a block; the masked outputs are summed into the
aggregate that ``postnet`` reads. The convs run over the padded frames
with no length mask, as in JAX, in f32 with cuDNN's TF32 off
(`nn.heads.Conv`, `ieee_call`). BatchNorm keeps running statistics (flax's
``batch_stats``: eval reads them; train takes the batch's over every frame
and leaves the running ones as they are, as the JAX package's NPC task
throws the update away). The hidden states are [blocks...,
masked..., aggregate]. The modules carry the reference's names:
``blocks.{i}.{conv,bn1,linear,bn2}``, ``masked_convs.{i}.conv``, ``postnet``.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Optional

import torch
import torch.nn as nn
import torch.nn.functional as F

from ..nn.heads import Conv, Dense, dropout, ieee_call


@dataclass(frozen=True)
class NPCConfig:
    """The JAX package's fields and defaults (its ``NPCConfig``)."""

    input_size: int = 80
    hidden_size: int = 512
    n_blocks: int = 4
    dropout: float = 0.1
    residual: bool = True
    kernel_size: int = 15  # odd
    mask_size: int = 5  # odd
    batch_norm: bool = True
    activate: str = "relu"
    disable_cross_layer: bool = False


def _batch_norm(bn: nn.BatchNorm1d, x: torch.Tensor, training: bool) -> torch.Tensor:
    """flax ``BatchNorm`` (eps 1e-5) on [B, T, C]; in training the batch's
    statistics leave the running ones as they are."""
    B, T, C = x.shape
    out = F.batch_norm(x.reshape(B * T, C), None if training else bn.running_mean,
                       None if training else bn.running_var, bn.weight, bn.bias, training,
                       0.0, bn.eps)
    return out.view(B, T, C)


class ConvBlock(nn.Module):
    def __init__(self, input_size: int, hidden_size: int, residual: bool, p: float,
                 batch_norm: bool, activate: str, device=None):
        super().__init__()
        self.residual, self.p = residual, p
        self.act = F.relu if activate == "relu" else torch.tanh
        self.conv = Conv(input_size, hidden_size, 3, device=device)
        self.linear = Conv(hidden_size, hidden_size, 1, device=device)
        self.bn1 = self.bn2 = None
        if batch_norm:
            self.bn1 = nn.BatchNorm1d(hidden_size, device=device)
            self.bn2 = nn.BatchNorm1d(hidden_size, device=device)

    def forward(self, x: torch.Tensor, generator: Optional[torch.Generator] = None):
        out = self.conv(x)
        if self.bn1 is not None:
            out = _batch_norm(self.bn1, out, self.training)
        out = self.linear(self.act(out))
        if self.bn2 is not None:
            out = _batch_norm(self.bn2, out, self.training)
        out = dropout(out, self.p, self.training, generator)
        if self.residual and x.shape[-1] == out.shape[-1]:
            out = out + x
        return self.act(out)


class MaskConvBlock(nn.Module):
    """tanh(conv) with the kernel's centre ``mask_size`` taps zeroed in
    the forward, padded (k - 1) / 2 frames a side."""

    def __init__(self, input_size: int, hidden_size: int, kernel_size: int, mask_size: int,
                 device=None):
        super().__init__()
        self.mask_size = mask_size
        self.conv = Conv(input_size, hidden_size, kernel_size, device=device)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        conv = self.conv
        k = conv.kernel_size[0]
        head = (k - self.mask_size) // 2
        mask = torch.ones(k, device=conv.weight.device)
        mask[head:head + self.mask_size] = 0.0
        pad = (k - 1) // 2

        def run(y):
            y = F.pad(y, (0, 0, pad, pad)).transpose(1, 2)
            return F.conv1d(y, conv.weight * mask, conv.bias).transpose(1, 2)

        return torch.tanh(ieee_call(run, x.to(conv.weight.dtype), [conv.weight, conv.bias]))


class NPCModel(nn.Module):
    """(feats [B, T, M], feat_lens [B]) -> (hiddens [2N+1, B, T, H] (N + 2
    with ``disable_cross_layer``), predicted [B, T, M], feat_lens)."""

    def __init__(self, cfg: NPCConfig = NPCConfig(), device=None):
        super().__init__()
        self.cfg = cfg
        H = cfg.hidden_size
        self.blocks = nn.ModuleList(
            ConvBlock(cfg.input_size if i == 0 else H, H, cfg.residual and i > 0, cfg.dropout,
                      cfg.batch_norm, cfg.activate, device) for i in range(cfg.n_blocks))
        # keyed by block: with disable_cross_layer only the last block has one
        last = cfg.n_blocks - 1
        self.masked_convs = nn.ModuleDict({
            str(i): MaskConvBlock(H, H, cfg.kernel_size, cfg.mask_size + 2 * (i + 1), device)
            for i in range(cfg.n_blocks) if not cfg.disable_cross_layer or i == last})
        self.postnet = Dense(H, cfg.input_size, device=device)

    def forward(self, feats: torch.Tensor, feat_lens: torch.Tensor,
                generator: Optional[torch.Generator] = None):
        x = feats
        agg = None
        block_outs, masked_outs = [], []
        for i, block in enumerate(self.blocks):
            x = block(x, generator)
            block_outs.append(x)
            if str(i) in self.masked_convs:
                masked = self.masked_convs[str(i)](x)
                masked_outs.append(masked)
                agg = masked if agg is None else agg + masked
        return torch.stack(block_outs + masked_outs + [agg]), self.postnet(agg), feat_lens
