"""APC / VQ-APC: autoregressive predictive coding over mel features (port
of s3prl_tpu/models/apc.py:25-98; the reference's apc/apc.py:26-160 and
vq.py:29-90).

A stack of one-way GRUs (`nn.heads.GRU`: cuDNN in f32 with TF32 off, over
the whole padded length as flax's ``nn.RNN``), dropout after every layer
and a residual from the second layer on; VQ-APC quantizes the last layer's
output by groups (the argmax code in eval, the straight-through Gumbel
softmax in train) before the ``postnet`` regression. The hidden states are
every GRU layer's output [N, B, T, H]. The modules carry the reference's
names: ``rnn_layers.{i}`` (single-layer GRUs), ``vq_layers.{g}.vq_logits``,
``vq_layers.{g}.codebook_CxE`` and ``postnet``.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Optional, Tuple

import torch
import torch.nn as nn
import torch.nn.functional as F

from ..nn.heads import GRU, Dense, dropout


@dataclass(frozen=True)
class APCConfig:
    """The JAX package's fields and defaults (its ``APCConfig``)."""

    input_size: int = 80  # log-mel
    hidden_size: int = 512
    num_layers: int = 3
    dropout: float = 0.1
    residual: bool = True
    # VQ (VQ-APC); None disables
    vq_codebook_size: Optional[Tuple[int, ...]] = None  # e.g. (512,)
    vq_code_dim: Optional[Tuple[int, ...]] = None  # e.g. (512,)
    vq_gumbel_temperature: float = 0.5


class VQLayer(nn.Module):
    """A Gumbel-softmax quantizer (reference apc/vq.py:29-90): ``vq_logits``
    [input_size -> codebook_size] and the codebook as ``codebook_CxE``
    (weight [code_dim, codebook_size]). Eval takes the argmax code (the
    one-hot product, exact as a lookup); train the straight-through
    Gumbel softmax drawn from `generator`."""

    def __init__(self, codebook_size: int, input_size: int, code_dim: int,
                 gumbel_temperature: float = 0.5, device=None):
        super().__init__()
        self.temperature = gumbel_temperature
        self.vq_logits = Dense(input_size, codebook_size, device=device)
        self.codebook_CxE = Dense(codebook_size, code_dim, bias=False, device=device)

    @staticmethod
    def draw_gumbel(logits: torch.Tensor, generator: Optional[torch.Generator]) -> torch.Tensor:
        """Standard Gumbel noise of the logits' shape (the JAX package's
        ``jax.random.gumbel``, from another stream)."""
        u = torch.rand(logits.shape, generator=generator, device=logits.device)
        return -torch.log(-torch.log(u.clamp_min(torch.finfo(u.dtype).tiny)))

    def forward(self, x: torch.Tensor, generator: Optional[torch.Generator] = None):
        logits = self.vq_logits(x)
        codebook = self.codebook_CxE.weight.t()  # [codebook_size, code_dim]
        if not self.training:
            return logits, F.embedding(logits.argmax(dim=-1), codebook)
        soft = torch.softmax((logits + self.draw_gumbel(logits, generator)) / self.temperature,
                             dim=-1)
        hard = F.one_hot(soft.argmax(dim=-1), soft.shape[-1]).to(soft.dtype)
        return logits, (hard + soft - soft.detach()) @ codebook


class APCModel(nn.Module):
    """(feats [B, T, M], feat_lens [B]) -> (hiddens [N, B, T, H], predicted
    [B, T, M], feat_lens)."""

    def __init__(self, cfg: APCConfig = APCConfig(), device=None):
        super().__init__()
        self.cfg = cfg
        H = cfg.hidden_size
        self.rnn_layers = nn.ModuleList(
            GRU(cfg.input_size if i == 0 else H, H, device=device) for i in range(cfg.num_layers))
        self.vq_layers, out = None, H
        if cfg.vq_codebook_size:
            # group g reads the last layer's features [offset, offset + cd)
            # (flax infers each width from its slice)
            offsets = [sum(cfg.vq_code_dim[:g]) for g in range(len(cfg.vq_code_dim))]
            self.vq_layers = nn.ModuleList(
                VQLayer(cs, len(range(H)[o:o + cd]), cd, cfg.vq_gumbel_temperature, device)
                for cs, cd, o in zip(cfg.vq_codebook_size, cfg.vq_code_dim, offsets))
            out = sum(cfg.vq_code_dim)
        self.postnet = Dense(out, cfg.input_size, device=device)

    def forward(self, feats: torch.Tensor, feat_lens: torch.Tensor,
                generator: Optional[torch.Generator] = None):
        cfg = self.cfg
        x = feats
        hiddens = []
        for i, rnn in enumerate(self.rnn_layers):
            out = dropout(rnn(x), cfg.dropout, self.training, generator)
            # the reference's order (apc.py:121-141): dropout on every layer,
            # the residual from the second layer on
            if cfg.residual and i > 0 and x.shape[-1] == out.shape[-1]:
                out = out + x
            hiddens.append(out)
            x = out
        if self.vq_layers is not None:
            parts, offset = [], 0
            for vq, cd in zip(self.vq_layers, cfg.vq_code_dim):
                parts.append(vq(x[..., offset:offset + cd], generator)[1])
                offset += cd
            x = torch.cat(parts, dim=-1)
        return torch.stack(hiddens), self.postnet(x), feat_lens
