"""Transformer decoder: causal self-attention, cross-attention (port of
s3prl_tpu/models/decoder.py).

The speech-translation task's decoder (reference: s3prl/downstream/
speech_translation, a fairseq S2T transformer; here an encoder-decoder of
the same shape): token embedding plus sinusoid positions, sinusoids on the
memory too, post-LN self / cross / FFN blocks with erf GELU and LayerNorm
eps 1e-5, ``memory_proj`` when the memory's width differs. The layers keep
flax's names (``embed``, ``self_{i}.q``, ``cross_{i}.out``, ``ln_ffn_{i}``,
``fc1_{i}``, ``output``, ...), so `upstream/convert.py`
`probe_state_dict_from_jax` maps a flax decoder's params onto it. Flax
infers the memory's width at init; here it is ``memory_size`` (the hidden
size by default).
"""

from __future__ import annotations

import functools
from dataclasses import dataclass
from typing import Optional

import numpy as np
import torch
import torch.nn as nn
import torch.nn.functional as F

from ..nn.heads import Dense, dropout
from ..ops.attention import scaled_dot_attention
from ..ops.masking import length_mask


@dataclass(frozen=True)
class DecoderConfig:
    vocab_size: int = 1000
    hidden_size: int = 256
    num_layers: int = 3
    num_heads: int = 4
    ffn_size: int = 1024
    dropout: float = 0.1
    max_positions: int = 1024


def sinusoid_table(max_len: int, hidden_size: int) -> np.ndarray:
    """Sinusoidal position table (a copy of s3prl_tpu/models/mockingjay.py
    `sinusoid_table`; reference: mockingjay builder.py:469-484)."""
    pos = np.arange(max_len)[:, None]
    dim = np.arange(hidden_size)[None, :]
    angle = pos / np.power(10000, 2 * (dim // 2) / hidden_size)
    table = np.zeros((max_len, hidden_size), np.float32)
    table[:, 0::2] = np.sin(angle[:, 0::2])
    table[:, 1::2] = np.cos(angle[:, 1::2])
    return table


def _positions(T: int, C: int, like: torch.Tensor) -> torch.Tensor:
    """[1, T, C] sinusoids on `like`'s device in its dtype, made once per
    (T, C, device, dtype): a host copy a call would stall the card at
    every greedy step."""
    return _device_positions(T, C, like.device, like.dtype)


@functools.lru_cache(maxsize=64)
def _device_positions(T: int, C: int, device: torch.device, dtype: torch.dtype) -> torch.Tensor:
    return torch.from_numpy(sinusoid_table(T, C)).to(device, dtype)[None]


class _CrossAttention(nn.Module):
    def __init__(self, hidden: int, heads: int):
        super().__init__()
        self.heads = heads
        self.q, self.k, self.v, self.out = (Dense(hidden, hidden) for _ in range(4))

    def forward(self, q_in, kv, kv_pad_mask=None, causal: bool = False):
        B, Tq, C = q_in.shape
        Tk = kv.shape[1]
        H, Dh = self.heads, C // self.heads
        q = self.q(q_in).reshape(B, Tq, H, Dh).transpose(1, 2)
        k = self.k(kv).reshape(B, Tk, H, Dh).transpose(1, 2)
        v = self.v(kv).reshape(B, Tk, H, Dh).transpose(1, 2)
        bias = None
        if causal:
            keep = torch.ones(Tq, Tk, dtype=torch.bool, device=q.device).tril()
            bias = torch.where(keep, 0.0, -1e9)[None, None]
        out = scaled_dot_attention(q * (Dh ** -0.5), k, v, kv_pad_mask, bias)
        return self.out(out.transpose(1, 2).reshape(B, Tq, C))


class TransformerDecoder(nn.Module):
    """(tokens [B, Tq], memory [B, Tk, memory_size], memory_lens [B]) ->
    logits [B, Tq, vocab] f32. Dropout (``cfg.dropout``, after the
    embedding) draws from the caller's generator in ``train()`` only."""

    def __init__(self, cfg: DecoderConfig = DecoderConfig(), memory_size: Optional[int] = None):
        super().__init__()
        self.cfg = cfg
        C = cfg.hidden_size
        self.embed = nn.Embedding(cfg.vocab_size, C)
        self.memory_proj = (Dense(memory_size, C)
                            if memory_size is not None and memory_size != C else None)
        for i in range(cfg.num_layers):
            self.add_module(f"self_{i}", _CrossAttention(C, cfg.num_heads))
            self.add_module(f"ln_self_{i}", nn.LayerNorm(C, eps=1e-5))
            self.add_module(f"cross_{i}", _CrossAttention(C, cfg.num_heads))
            self.add_module(f"ln_cross_{i}", nn.LayerNorm(C, eps=1e-5))
            self.add_module(f"fc1_{i}", Dense(C, cfg.ffn_size))
            self.add_module(f"fc2_{i}", Dense(cfg.ffn_size, C))
            self.add_module(f"ln_ffn_{i}", nn.LayerNorm(C, eps=1e-5))
        self.output = Dense(C, cfg.vocab_size)

    def forward(self, tokens: torch.Tensor, memory: torch.Tensor, memory_lens: torch.Tensor,
                generator: Optional[torch.Generator] = None) -> torch.Tensor:
        cfg = self.cfg
        C = cfg.hidden_size
        x = self.embed(tokens)
        x = x + _positions(tokens.shape[1], C, x)
        x = dropout(x, cfg.dropout, self.training, generator)
        mem_pad = ~length_mask(memory_lens.to(memory.device), memory.shape[1])
        if memory.shape[-1] != C:
            if self.memory_proj is None:
                raise ValueError(f"memory of width {memory.shape[-1]}: build the decoder "
                                 f"with memory_size={memory.shape[-1]}")
            memory = self.memory_proj(memory)
        # sinusoid positions on the memory too (the fairseq S2T encoder the
        # reference wraps adds them to the encoder's states): without them
        # cross-attention addresses the memory by content alone
        memory = memory + _positions(memory.shape[1], C, memory)
        for i in range(cfg.num_layers):
            h = getattr(self, f"self_{i}")(x, x, None, causal=True)
            x = getattr(self, f"ln_self_{i}")(x + h)
            h = getattr(self, f"cross_{i}")(x, memory, mem_pad)
            x = getattr(self, f"ln_cross_{i}")(x + h)
            h = getattr(self, f"fc2_{i}")(F.gelu(getattr(self, f"fc1_{i}")(x)))
            x = getattr(self, f"ln_ffn_{i}")(x + h)
        return self.output(x)
