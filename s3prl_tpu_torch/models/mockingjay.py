"""Mockingjay / TERA / AudioALBERT: BERT-style encoders over acoustic
features (port of s3prl_tpu/models/mockingjay.py:30-182).

Post-LN (or pre-LN) BERT blocks with layer norms at eps 1e-12 (f32
statistics) and erf GELU over a projection of the features plus the
sinusoid position table; AudioALBERT (``share_layer``) holds one block and
calls it at every depth. The JAX package's numerics: q is pre-scaled by
Dh ** -0.5 and `ops.attention.scaled_dot_attention` replaces the scores of
padded keys by -1e9 (f32 scores and softmax); ``hidden_dropout_prob``
drops after the input LN and after each sublayer, ``attention_probs_dropout_prob``
is never applied (as in JAX). Matrices run in ``dtype`` (flax's ``Dense(dtype=...)``
over f32 parameters), the norms in f32, cast back to ``dtype``.

The modules carry the reference TransformerModel's names
(``input_representations.spec_transform``, ``encoder.layer.{i}.attention.self.query``,
..., s3prl_tpu/upstream/convert.py:434-468), so a reference state_dict
loads once its ``transformer.`` prefix is stripped; under ``share_layer``
the state_dict holds ``encoder.layer.0`` only.
"""

from __future__ import annotations

from dataclasses import dataclass
from functools import lru_cache
from typing import Optional

import numpy as np
import torch
import torch.nn as nn
import torch.nn.functional as F

from ..nn.heads import Dense, dropout
from ..ops.attention import scaled_dot_attention
from ..ops.masking import length_mask


@dataclass(frozen=True)
class MockingjayConfig:
    """The JAX package's fields and defaults (its ``MockingjayConfig``)."""

    input_dim: int = 240  # fbank 80 + deltas (mockingjay); 80 for TERA's mel
    hidden_size: int = 768
    num_hidden_layers: int = 3
    num_attention_heads: int = 12
    intermediate_size: int = 3072
    hidden_act: str = "gelu"
    hidden_dropout_prob: float = 0.1
    attention_probs_dropout_prob: float = 0.1
    layer_norm_eps: float = 1e-12
    share_layer: bool = False  # True = AudioALBERT
    pre_layer_norm: bool = False
    downsample_rate: int = 1  # consecutive-frame stacking factor


@lru_cache(maxsize=8)
def sinusoid_table(max_len: int, hidden_size: int) -> np.ndarray:
    """The sinusoid position table, built in float64 numpy and cast to f32
    (a copy of s3prl_tpu/models/mockingjay.py:45-55)."""
    pos = np.arange(max_len)[:, None]
    dim = np.arange(hidden_size)[None, :]
    angle = pos / np.power(10000, 2 * (dim // 2) / hidden_size)
    table = np.zeros((max_len, hidden_size), np.float32)
    table[:, 0::2] = np.sin(angle[:, 0::2])
    table[:, 1::2] = np.cos(angle[:, 1::2])
    return table


_ACTS = {"gelu": F.gelu, "relu": F.relu, "swish": F.silu}


def _modules(**children: nn.Module) -> nn.Module:
    """A bare container, so the children's keys nest as the reference's."""
    box = nn.Module()
    for name, child in children.items():
        box.add_module(name, child)
    return box


def _dense(layer: Dense, x: torch.Tensor, dtype: torch.dtype) -> torch.Tensor:
    """flax ``Dense(dtype=dtype)``: input, kernel and bias in ``dtype``."""
    return F.linear(x.to(dtype), layer.weight.to(dtype), layer.bias.to(dtype))


def _norm(ln: nn.LayerNorm, x: torch.Tensor, dtype: torch.dtype) -> torch.Tensor:
    """flax ``LayerNorm(dtype=f32)`` then the cast to ``dtype``."""
    return F.layer_norm(x.float(), ln.normalized_shape, ln.weight, ln.bias, ln.eps).to(dtype)


class BertLayer(nn.Module):
    """One post-LN (or pre-LN) block (reference model.py:126-331):
    ``attention.self.{query,key,value}``, ``attention.output.{dense,LayerNorm}``,
    ``intermediate.dense``, ``output.{dense,LayerNorm}``."""

    def __init__(self, cfg: MockingjayConfig, dtype: torch.dtype = torch.float32, device=None):
        super().__init__()
        C, Fd, eps = cfg.hidden_size, cfg.intermediate_size, cfg.layer_norm_eps
        self.cfg, self.dtype = cfg, dtype
        self.attention = _modules(
            self=_modules(query=Dense(C, C, device=device), key=Dense(C, C, device=device),
                          value=Dense(C, C, device=device)),
            output=_modules(dense=Dense(C, C, device=device),
                            LayerNorm=nn.LayerNorm(C, eps=eps, device=device)))
        self.intermediate = _modules(dense=Dense(C, Fd, device=device))
        self.output = _modules(dense=Dense(Fd, C, device=device),
                               LayerNorm=nn.LayerNorm(C, eps=eps, device=device))

    def _attention(self, h, pad, generator):
        B, T, C = h.shape
        H = self.cfg.num_attention_heads
        Dh = C // H
        proj = self.attention.self

        def heads(layer):
            return _dense(layer, h, self.dtype).view(B, T, H, Dh).transpose(1, 2)

        out = scaled_dot_attention(heads(proj.query) * (Dh ** -0.5), heads(proj.key),
                                   heads(proj.value), pad)
        out = _dense(self.attention.output.dense, out.transpose(1, 2).reshape(B, T, C),
                     self.dtype)
        return dropout(out, self.cfg.hidden_dropout_prob, self.training, generator)

    def _ffn(self, h, generator):
        inner = _ACTS[self.cfg.hidden_act](_dense(self.intermediate.dense, h, self.dtype))
        out = _dense(self.output.dense, inner, self.dtype)
        return dropout(out, self.cfg.hidden_dropout_prob, self.training, generator)

    def forward(self, x: torch.Tensor, pad: torch.Tensor,
                generator: Optional[torch.Generator] = None) -> torch.Tensor:
        """x [B, T, C] in ``dtype``, pad [B, T] True on padded frames."""
        ln_attn, ln_out = self.attention.output.LayerNorm, self.output.LayerNorm
        if self.cfg.pre_layer_norm:
            x = x + self._attention(_norm(ln_attn, x, self.dtype), pad, generator)
            return x + self._ffn(_norm(ln_out, x, self.dtype), generator)
        x = _norm(ln_attn, x + self._attention(x, pad, generator), self.dtype)
        return _norm(ln_out, x + self._ffn(x, generator), self.dtype)


class MockingjayEncoder(nn.Module):
    """Input projection + sinusoid positions + LN + N blocks: (feats [B, T,
    D], feat_lens [B]) -> (hidden_states [N+1, B, T, H], feat_lens), the
    input of every block then the last output (reference model.py:359-388).
    ``downsample_rate > 1`` stacks that many consecutive frames first (T //
    rate frames, lengths // rate)."""

    def __init__(self, cfg: MockingjayConfig = MockingjayConfig(),
                 dtype: torch.dtype = torch.float32, device=None):
        super().__init__()
        self.cfg, self.dtype = cfg, dtype
        H = cfg.hidden_size
        self.input_representations = _modules(
            spec_transform=Dense(cfg.input_dim * cfg.downsample_rate, H, device=device),
            LayerNorm=nn.LayerNorm(H, eps=cfg.layer_norm_eps, device=device))
        depth = 1 if cfg.share_layer else cfg.num_hidden_layers
        self.encoder = _modules(layer=nn.ModuleList(
            BertLayer(cfg, dtype, device) for _ in range(depth)))

    def forward(self, feats: torch.Tensor, feat_lens: torch.Tensor,
                generator: Optional[torch.Generator] = None):
        cfg = self.cfg
        B, T, D = feats.shape
        dr = cfg.downsample_rate
        if dr > 1:  # consecutive-frame stacking (the reference's down_sample_frames)
            T = T // dr
            feats = feats[:, :T * dr].reshape(B, T, D * dr)
            feat_lens = torch.div(feat_lens, dr, rounding_mode="floor")
        inputs = self.input_representations
        x = _dense(inputs.spec_transform, feats, self.dtype)
        table = torch.from_numpy(sinusoid_table(T, cfg.hidden_size)).to(x.device, x.dtype)
        x = _norm(inputs.LayerNorm, x + table, self.dtype)
        x = dropout(x, cfg.hidden_dropout_prob, self.training, generator)
        pad = ~length_mask(feat_lens.to(x.device), T)
        layers = self.encoder.layer
        states = []
        for i in range(cfg.num_hidden_layers):
            states.append(x)
            x = layers[0 if cfg.share_layer else i](x, pad, generator)
        states.append(x)
        return torch.stack(states), feat_lens


class SpecPredictionHead(nn.Module):
    """The masked-spectrogram prediction head (reference model.py:389-412):
    ``dense`` -> activation -> ``LayerNorm`` -> ``output``."""

    def __init__(self, cfg: MockingjayConfig, output_dim: int,
                 dtype: torch.dtype = torch.float32, device=None):
        super().__init__()
        self.cfg, self.dtype = cfg, dtype
        H = cfg.hidden_size
        self.dense = Dense(H, H, device=device)
        self.LayerNorm = nn.LayerNorm(H, eps=cfg.layer_norm_eps, device=device)
        self.output = Dense(H, output_dim, device=device)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        x = _ACTS[self.cfg.hidden_act](_dense(self.dense, x, self.dtype))
        return _dense(self.output, _norm(self.LayerNorm, x, self.dtype), self.dtype)
