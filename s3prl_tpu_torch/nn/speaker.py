"""Speaker models: the x-vector TDNN (SUPERB ASV) and the diarization head
(port of s3prl_tpu/nn/speaker.py).

Behavioral spec from the reference's s3prl/nn/speaker_model.py: TDNN:34
(context-size dilated VALID conv + ReLU + dropout), XVectorBackbone:128
(512-512-512-512-1500 with contexts 5,3,3,1,1 and dilations 1,2,3,1,1 -
total length reduction 14 frames), SuperbXvector:463 (projector -> TDNNs ->
pooling -> affine; the second affine layer applies in training only, as in
the JAX package), the GE2E recipe's projector + self-attentive pooling, and
the frame-level diarization model (nn/rnn.py SuperbDiarizationModel:
unidirectional LSTM stack + linear).

The layers keep flax's names (``tdnns.tdnn_{i}.conv``, ``pool``,
``affine1``, ``lstm_{i}``, ...), so `probe_state_dict_from_jax` maps a flax
tree onto them, and each head takes its input width up front. The TDNN
convs (`heads.Conv`, VALID) and the LSTMs run cuDNN in full f32, as the
JAX modules compute in f32; a stack over fewer than 15 frames carries an
empty time axis through to the pooling, as flax does.
"""

from __future__ import annotations

from typing import Optional

import torch
import torch.nn as nn
import torch.nn.functional as F

from .heads import LSTM, POOLINGS, Conv, Dense, SelfAttentivePooling, dropout

XVECTOR_TDNNS_LENGTH_REDUCTION = 14
XVECTOR_SPECS = ((512, 5, 1), (512, 3, 2), (512, 3, 3), (512, 1, 1))  # (out, context, dilation)


class TDNN(nn.Module):
    """A dilated VALID conv, ReLU and dropout on [B, T, C]. ``batch_norm``
    raises: the JAX package's task init keeps only the "params" collection
    (s3prl_tpu/task/speaker_verification.py:54-56), so its BatchNorm has no
    statistics and a train apply raises flax's ModifyScopeVariableError;
    the port does not train what JAX cannot."""

    def __init__(self, input_size: int, output_size: int, context_size: int = 5,
                 dilation: int = 1, dropout_p: float = 0.0, batch_norm: bool = False):
        super().__init__()
        if batch_norm:
            raise NotImplementedError(
                "TDNN(batch_norm=True): the JAX package cannot train it (its init drops the "
                "batch_stats collection and a train apply raises ModifyScopeVariableError)")
        self.p = dropout_p
        self.conv = Conv(input_size, output_size, context_size, dilation, padding="VALID")

    def forward(self, x: torch.Tensor, generator: Optional[torch.Generator] = None):
        return dropout(F.relu(self.conv(x)), self.p, self.training, generator)


class XVectorBackbone(nn.Module):
    """The five TDNNs ``tdnn_0`` .. ``tdnn_4``: [B, T, C] -> [B, T - 14,
    output_size] (an empty time axis below 15 frames)."""

    def __init__(self, input_size: int, output_size: int = 1500, dropout_p: float = 0.0,
                 batch_norm: bool = False):
        super().__init__()
        specs = (*XVECTOR_SPECS, (output_size, 1, 1))
        for i, (out, ctx, dil) in enumerate(specs):
            self.add_module(f"tdnn_{i}", TDNN(input_size, out, ctx, dil, dropout_p, batch_norm))
            input_size = out
        self.n = len(specs)

    def forward(self, x: torch.Tensor, generator: Optional[torch.Generator] = None):
        for i in range(self.n):
            x = getattr(self, f"tdnn_{i}")(x, generator)
        return x


class SuperbXvector(nn.Module):
    """x-vector extractor: (features [B, T, input_size], lens [B]) -> emb
    [B, output_size]. `pooling` selects the aggregation (statistics pooling
    for SuperbASV, SAP for the segment-eval recipe); it sizes ``affine1``'s
    input (2 x aggregation_size or aggregation_size). ``affine2`` (and its
    ReLU) applies in ``train()`` only; it always exists, so the parameters
    do not depend on the mode."""

    def __init__(self, input_size: int, output_size: int = 512, hidden_size: int = 512,
                 aggregation_size: int = 1500, dropout_p: float = 0.0, batch_norm: bool = False,
                 pooling: str = "TemporalStatisticsPooling"):
        super().__init__()
        self.output_size = output_size
        self.projector = Dense(input_size, hidden_size)
        self.tdnns = XVectorBackbone(hidden_size, aggregation_size, dropout_p, batch_norm)
        self.pool = POOLINGS[pooling](aggregation_size)
        self.affine1 = Dense(self.pool.output_size, output_size)
        self.affine2 = Dense(output_size, output_size)

    def forward(self, xs, xs_len, generator=None):
        x = self.tdnns(self.projector(xs), generator)
        x_len = torch.clamp(xs_len - XVECTOR_TDNNS_LENGTH_REDUCTION, min=1)
        h = F.relu(self.affine1(self.pool(x, x_len)))
        return F.relu(self.affine2(h)) if self.training else h


class SapSpeakerHead(nn.Module):
    """Projector to `input_dim` + self-attentive pooling (the GE2E recipe's
    embedder: modelrc module Identity, input_dim 256, agg_module SAP)."""

    def __init__(self, input_size: int, input_dim: int = 256):
        super().__init__()
        self.output_size = input_dim
        self.projector = Dense(input_size, input_dim)
        self.sap = SelfAttentivePooling(input_dim)

    def forward(self, xs, xs_len, generator=None):
        return self.sap(self.projector(xs), xs_len)


class SuperbDiarizationModel(nn.Module):
    """Frame-level multi-speaker activity head: `num_layers` unidirectional
    `LSTM`s (``lstm_{i}``) and ``linear``; returns (logits f32 [B, T,
    output_size], xs_len). Valid frames match flax's; padded frames are
    zeros (flax's carry on over them). `xs_len` should be a host tensor:
    ``pack_padded_sequence`` takes its lengths there."""

    def __init__(self, input_size: int, output_size: int = 2, hidden_size: int = 512,
                 num_layers: int = 3):
        super().__init__()
        self.num_layers = num_layers
        for i in range(num_layers):
            self.add_module(f"lstm_{i}", LSTM(input_size if i == 0 else hidden_size,
                                              hidden_size, bidirectional=False))
        self.linear = Dense(hidden_size, output_size)

    def forward(self, xs, xs_len, generator=None):
        lens = xs_len.cpu()
        for i in range(self.num_layers):
            xs = getattr(self, f"lstm_{i}")(xs, lens)
        return self.linear(xs), xs_len
