"""Taco2-AR voice-conversion decoder (port of s3prl_tpu/models/taco2ar.py;
the reference's a2o-vc-vcc2020 / a2a-vc-vctk recipes): a prenet over the
previous mel frame, LSTMs over [feature_t, prenet(mel_{t-1})] (plus an
optional speaker embedding), a linear mel projection and a conv postnet
added to it. Teacher forcing runs the whole sequence in one pass.

- `_Prenet`: two ReLU ``Dense`` layers (``fc0``, ``fc1``), each followed by
  dropout `PRENET_DROPOUT` that stays on at inference too (Tacotron's
  prenet, taco2ar.py:39-41), drawn from the caller's generator;
- ``lstm_{i}``: flax's one-bias ``OptimizedLSTMCell`` over the whole padded
  length (``nn.RNN`` without ``seq_lengths``) as the port's one-way `LSTM`
  (cuDNN with TF32 off, ``bias_ih`` held at zero);
- ``mel_out`` and ``postnet_{i}``: SAME-padded convs with tanh between them,
  the last one back to the mel width.
The names are flax's, so `upstream.convert.probe_state_dict_from_jax`
carries a JAX model's params across.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Optional

import torch
import torch.nn as nn
import torch.nn.functional as F

from ..nn.heads import LSTM, Conv, Dense, dropout

#: the prenet's dropout rate, on in train and eval mode alike
PRENET_DROPOUT = 0.5


@dataclass(frozen=True)
class Taco2ARConfig:
    """The JAX package's fields and defaults."""

    mel_dim: int = 80
    prenet_units: int = 256
    lstm_units: int = 512
    num_lstm_layers: int = 2
    spk_embed_dim: int = 0  # > 0 enables any-to-any conditioning
    postnet_channels: int = 256
    postnet_kernel: int = 5
    postnet_layers: int = 3


class _Prenet(nn.Module):
    def __init__(self, input_size: int, units: int):
        super().__init__()
        self.fc0 = Dense(input_size, units)
        self.fc1 = Dense(units, units)

    def forward(self, x: torch.Tensor, generator: Optional[torch.Generator]) -> torch.Tensor:
        for fc in (self.fc0, self.fc1):
            x = dropout(F.relu(fc(x)), PRENET_DROPOUT, True, generator)
        return x


class Taco2ARDecoder(nn.Module):
    """(features [B, T, H], prev_mels [B, T, mel], spk_embed [B, S] or None)
    -> predicted mels [B, T, mel] f32."""

    def __init__(self, cfg: Taco2ARConfig, input_size: int):
        super().__init__()
        self.cfg = cfg
        self.prenet = _Prenet(cfg.mel_dim, cfg.prenet_units)
        size = input_size + cfg.prenet_units + cfg.spk_embed_dim
        for i in range(cfg.num_lstm_layers):
            self.add_module(f"lstm_{i}", LSTM(size, cfg.lstm_units, bidirectional=False,
                                              carry_padding=True))
            size = cfg.lstm_units
        self.mel_out = Dense(size, cfg.mel_dim)
        size = cfg.mel_dim
        for i in range(cfg.postnet_layers):
            out = cfg.mel_dim if i == cfg.postnet_layers - 1 else cfg.postnet_channels
            self.add_module(f"postnet_{i}", Conv(size, out, cfg.postnet_kernel))
            size = out

    def forward(self, features: torch.Tensor, prev_mels: torch.Tensor,
                spk_embed: Optional[torch.Tensor] = None,
                generator: Optional[torch.Generator] = None) -> torch.Tensor:
        cfg = self.cfg
        x = torch.cat([features.float(), self.prenet(prev_mels.float(), generator)], dim=-1)
        if cfg.spk_embed_dim and spk_embed is not None:
            x = torch.cat([x, spk_embed[:, None].expand(-1, x.shape[1], -1)], dim=-1)
        lens = torch.full((x.shape[0],), x.shape[1], dtype=torch.int64)
        for i in range(cfg.num_lstm_layers):
            x = getattr(self, f"lstm_{i}")(x, lens)
        mel = self.mel_out(x)
        y = mel
        for i in range(cfg.postnet_layers):
            y = getattr(self, f"postnet_{i}")(y)
            if i < cfg.postnet_layers - 1:
                y = torch.tanh(y)
        return mel + y
