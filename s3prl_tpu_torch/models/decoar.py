"""DeCoAR 1 and 2 over Kaldi fbank 80 + CMVN (port of
s3prl_tpu/models/decoar.py and decoar2.py; the reference's
decoar{,_layers}/decoar.py and decoar2/decoar2.py).

`DecoarModel`: Dense(1024), then four forward and four backward one-layer
LSTMs. The backward stack is its own chain: layer i consumes layer i - 1's
backward output, each row reversed within its valid frames (flax's
``reverse=True, keep_order=True``), so it runs as one-way LSTMs over the
flipped sequence (`nn.heads.flip_valid`), each output flipped back. Both
stacks run over the whole padded length, as flax's do. ``decoar`` serves
the last layer's [forward; backward] (one state), ``decoar_layers`` every
layer's (four). The modules carry decoar_layers' keys
(``forward_lstms.{i}``, ``backward_lstms.{i}``); f32 only, cuDNN with
TF32 off (`ieee_call`). flax's cells have one bias a gate: ``bias_ih``
holds zeros.

`Decoar2Model`: Dense(768) (dropout 0.1 in train mode), then the port's
post-LN conv-pos `TransformerEncoder` (768 wide, 12 heads, FFN 3,072, its
depth from the checkpoint; dropout 0.1 in train mode) on stock ops, in f32
or bf16: L + 1 hidden states. Its pos-conv has 48 channels a group (768 in
16), which the card's pos-conv kernels (64 a group) do not take.
"""

from __future__ import annotations

from dataclasses import dataclass

import torch
import torch.nn as nn
import torch.nn.functional as F

from ..nn.heads import dropout, flip_valid, ieee_call
from .baseline import baseline_features
from .transformer import TransformerEncoder

FBANK = dict(feat_type="fbank", num_mel_bins=80, delta_order=0, cmvn=True)  # audio.py:45


@dataclass(frozen=True)
class DecoarConfig:
    per_layer: bool = False  # decoar_layers
    hidden: int = 1024
    num_layers: int = 4


class DecoarModel(nn.Module):
    """(wavs [B, T], wav_lens [B]) -> (hidden states [1 or 4, B, T', 2048]
    f32, feat_lens [B])."""

    def __init__(self, cfg: DecoarConfig = DecoarConfig(), device=None):
        super().__init__()
        self.cfg = cfg
        H = cfg.hidden
        self.post_extract_proj = nn.Linear(80, H, device=device)
        self.forward_lstms = nn.ModuleList(nn.LSTM(H, H, batch_first=True, device=device)
                                           for _ in range(cfg.num_layers))
        self.backward_lstms = nn.ModuleList(nn.LSTM(H, H, batch_first=True, device=device)
                                            for _ in range(cfg.num_layers))

    def _states(self, feats: torch.Tensor, feat_lens: torch.Tensor) -> torch.Tensor:
        x = F.linear(feats, self.post_extract_proj.weight, self.post_extract_proj.bias)
        fwd, back = x, flip_valid(x, feat_lens)
        states = []
        for forward, backward in zip(self.forward_lstms, self.backward_lstms):
            fwd, back = forward(fwd)[0], backward(back)[0]
            states.append(torch.cat([fwd, flip_valid(back, feat_lens)], dim=-1))
        return torch.stack(states if self.cfg.per_layer else states[-1:])

    def forward(self, wavs: torch.Tensor, wav_lens: torch.Tensor, generator=None):
        """`generator` is taken and not read: the JAX upstream runs the model
        alike in train mode."""
        feats, feat_lens = baseline_features(wavs, wav_lens, **FBANK)
        hs = ieee_call(lambda f: self._states(f, feat_lens), feats, self.parameters())
        return hs, feat_lens


@dataclass(frozen=True)
class Decoar2Config:
    num_layers: int = 12  # the reference default (decoar2.py:12)
    dropout: float = 0.1


class Decoar2Model(nn.Module):
    """(wavs [B, T], wav_lens [B]) -> (hidden states [L + 1, B, T', 768] in
    the model dtype, feat_lens [B])."""

    def __init__(self, cfg: Decoar2Config = Decoar2Config(), dtype=torch.float32, device=None):
        super().__init__()
        self.cfg, self.dtype = cfg, dtype
        self.post_extract_proj = nn.Linear(80, 768, device=device)
        self.encoder = TransformerEncoder(
            embed_dim=768, ffn_dim=3072, num_layers=cfg.num_layers, num_heads=12,
            layer_norm_first=False, conv_pos=128, conv_pos_groups=16, dtype=dtype,
            dropout=cfg.dropout, device=device)

    def forward(self, wavs: torch.Tensor, wav_lens: torch.Tensor, generator=None):
        """`generator`: train mode's dropouts (the projection's and the
        encoder's)."""
        feats, feat_lens = baseline_features(wavs, wav_lens, **FBANK)
        proj = self.post_extract_proj

        def states(f):
            x = F.linear(f.to(self.dtype), proj.weight.to(self.dtype), proj.bias.to(self.dtype))
            x = dropout(x, self.cfg.dropout, self.training, generator)
            return self.encoder(x, feat_lens, generator=generator)

        return ieee_call(states, feats, self.parameters()), feat_lens
