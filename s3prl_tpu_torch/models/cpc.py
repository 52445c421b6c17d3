"""Modified CPC (FAIR): a strided conv encoder and an autoregressive
LSTM / GRU / tanh-RNN context (port of s3prl_tpu/models/cpc.py; the
reference's cpc/model.py CPCEncoder:62 and CPCAR:152).

Five padded strided convs (k 10 / 8 / 4 / 4 / 4, stride 5 / 4 / 2 / 2 / 2,
pad 3 / 2 / 1 / 1 / 1: stride 160), each followed by `ChannelNorm` and ReLU,
give z; a multi-layer one-way RNN over the whole padded length gives c
(flax's ``nn.RNN`` with ``seq_lengths`` only picks the last carry, so its
outputs run on over padded frames, as cuDNN's do here). The hidden states
are [z, c]. The modules carry the reference's keys (``gEncoder.conv{i}``,
``gEncoder.batchNorm{i}``, ``gAR.baseNet``); flax's cells have one bias
where torch's have two, so the port holds them as the JAX converter
folds them (`upstream.convert_zoo`): the LSTM's sum in ``bias_hh`` (zeros
in ``bias_ih``), the GRU's r / z sums in ``bias_ih`` (zeros in
``bias_hh``), the tanh RNN's bias in ``bias_ih``. f32 only; cuDNN runs with
TF32 off (`ieee_call`).
"""

from __future__ import annotations

from dataclasses import dataclass

import torch
import torch.nn as nn
import torch.nn.functional as F

from ..nn.heads import ieee_call

ENCODER_SPECS = ((10, 5, 3), (8, 4, 2), (4, 2, 1), (4, 2, 1), (4, 2, 1))  # (k, stride, pad)
AR_MODES = {"lstm": nn.LSTM, "gru": nn.GRU, "rnn": nn.RNN}


@dataclass(frozen=True)
class CPCConfig:
    """The JAX package's fields and defaults (its ``CPCConfig``)."""

    hidden_size: int = 256  # hiddenEncoder
    ar_size: int = 256  # hiddenGar
    ar_layers: int = 1  # nLevelsGRU
    ar_mode: str = "lstm"  # arMode (cpc_default_config.py:141-146)


class ChannelNorm(nn.Module):
    """The reference's ChannelNorm (cpc/model.py:33-59): each frame over
    its channels with the unbiased variance, weight and bias [1, C, 1]."""

    def __init__(self, channels: int, eps: float = 1e-5, device=None):
        super().__init__()
        self.eps = eps
        self.weight = nn.Parameter(torch.empty(1, channels, 1, device=device))
        self.bias = nn.Parameter(torch.empty(1, channels, 1, device=device))

    @torch.no_grad()
    def reset_parameters(self, generator=None) -> None:
        self.weight.fill_(1.0)
        self.bias.zero_()

    def forward(self, x: torch.Tensor) -> torch.Tensor:  # [B, C, T]
        C = x.shape[1]
        mean = x.mean(1, keepdim=True)
        var = (x - mean).square().mean(1, keepdim=True) * (C / max(C - 1, 1))
        return (x - mean) * torch.rsqrt(var + self.eps) * self.weight + self.bias


class CPCModel(nn.Module):
    """(wavs [B, T], wav_lens [B]) -> (hidden states [2, B, T', H] f32,
    feat_lens [B])."""

    def __init__(self, cfg: CPCConfig = CPCConfig(), device=None):
        super().__init__()
        if cfg.ar_mode not in AR_MODES:
            raise ValueError(f"ar_mode {cfg.ar_mode!r}: one of {sorted(AR_MODES)}")
        if cfg.hidden_size != cfg.ar_size:
            raise ValueError(
                f"hiddenEncoder {cfg.hidden_size} != hiddenGar {cfg.ar_size}: the JAX model "
                "stacks z and c through a z_proj that no checkpoint holds, so it cannot apply "
                "one (s3prl_tpu/models/cpc.py:73-76)")
        self.cfg = cfg
        H = cfg.hidden_size
        self.gEncoder = nn.Module()
        for i, (k, s, p) in enumerate(ENCODER_SPECS):
            self.gEncoder.add_module(f"conv{i}", nn.Conv1d(1 if i == 0 else H, H, k, s, p,
                                                           device=device))
            self.gEncoder.add_module(f"batchNorm{i}", ChannelNorm(H, device=device))
        self.gAR = nn.Module()
        self.gAR.baseNet = AR_MODES[cfg.ar_mode](H, cfg.ar_size, num_layers=cfg.ar_layers,
                                                 batch_first=True, device=device)

    def feat_lengths(self, wav_lens: torch.Tensor) -> torch.Tensor:
        for k, s, p in ENCODER_SPECS:
            wav_lens = torch.div(wav_lens + 2 * p - k, s, rounding_mode="floor") + 1
        return wav_lens

    def _states(self, wavs: torch.Tensor) -> torch.Tensor:
        x = wavs.float()[:, None]
        for i in range(len(ENCODER_SPECS)):
            conv = getattr(self.gEncoder, f"conv{i}")
            x = F.relu(getattr(self.gEncoder, f"batchNorm{i}")(conv(x)))
        z = x.transpose(1, 2)
        c = self.gAR.baseNet(z)[0]
        return torch.stack([z, c])

    def forward(self, wavs: torch.Tensor, wav_lens: torch.Tensor, generator=None):
        """`generator` is taken and not read: the model has no dropout, so
        train mode computes the same states, as in JAX."""
        hs = ieee_call(self._states, wavs, self.parameters())
        return hs, self.feat_lengths(wav_lens)
