"""wav2vec 1.0 / vq-wav2vec: fully convolutional CPC-style models (port of
s3prl_tpu/models/wav2vec1.py; the reference's wav2vec_model.py
ConvFeatureExtractionModel, ConvAggegator and the vq-wav2vec quantizers).

On [B, T, C] activations in the model dtype (f32 or bf16), stock ops only:
- the feature extractor: unpadded strided convs without bias -> GroupNorm
  with one group over the whole padded [T, C] of each row (f32, cast to the
  model dtype) -> ReLU, optional strided skips, then log(|x| + 1). The
  norm covers the padding, so a short row's features depend on the batch's
  padded length, as in the JAX package and the reference;
- an optional quantizer between z and the aggregator: `GumbelQuantizer`
  (eval: the argmax code's codeword) or `KmeansQuantizer` (the nearest
  codeword by L2 distance, straight-through);
- the aggregator: causal convs, left-padded by k - 1 frames (replicating
  the first frame, or zeros with ``agg_zero_pad``), GroupNorm(1) -> ReLU,
  residuals (through a 1x1 projection where the widths differ) scaled by
  sqrt(residual_scale).

The hidden states are the expert's hooks (wav2vec/expert.py:20-34): z, the
aggregator's layer inputs 1.., its output. The modules carry the
reference's keys (``feature_extractor.conv_layers.{i}.0`` / ``.2``,
``feature_aggregator.conv_layers.{i}.1`` / ``.3``,
``feature_aggregator.residual_proj.{i}``, ``vector_quantizer.*``). cuDNN
runs the f32 convs with TF32 off (`ieee_call`).
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Tuple

import torch
import torch.nn as nn
import torch.nn.functional as F

from ..nn.heads import Dense, dropout, ieee_call
from ..ops.masking import lengths_after_conv1d

W2V1_FEATURE_LAYERS = (
    (512, 10, 5), (512, 8, 4), (512, 4, 2), (512, 4, 2),
    (512, 4, 2), (512, 1, 1), (512, 1, 1), (512, 1, 1),
)
W2V1_AGG_LAYERS = tuple((512, k, 1) for k in range(2, 14))


@dataclass(frozen=True)
class Wav2Vec1Config:
    """The JAX package's fields and defaults (its ``Wav2Vec1Config``)."""

    conv_feature_layers: Tuple = W2V1_FEATURE_LAYERS
    conv_aggregator_layers: Tuple = W2V1_AGG_LAYERS
    log_compression: bool = True
    skip_connections_feat: bool = False
    skip_connections_agg: bool = True
    residual_scale: float = 0.5
    non_affine_group_norm: bool = False
    agg_zero_pad: bool = False
    dropout: float = 0.0
    conv_bias: bool = True  # aggregator convs (fairseq `not no_conv_bias`)
    vq_type: str = "none"  # "none" | "gumbel" | "kmeans"
    vq_vars: int = 320
    vq_groups: int = 2
    vq_dim: int = 0  # 0 -> feature dim
    vq_depth: int = 1
    combine_groups: bool = False

    @property
    def downsample_rate(self) -> int:
        out = 1
        for _, _, s in self.conv_feature_layers:
            out *= s
        return out


def group_norm(y: torch.Tensor, norm: nn.GroupNorm) -> torch.Tensor:
    """flax's ``GroupNorm(num_groups, dtype=f32)`` of y [B, T, C]: the
    statistics of each row and group over its T frames (padded ones
    included) and C / G channels in f32, the variance max(0, E[x^2] -
    E[x]^2), the scale multiplying rsqrt(var + eps) before the centred
    input does; f32 out."""
    B, T, C = y.shape
    G = norm.num_groups
    x = y.float().reshape(B, T, G, C // G)
    mean = x.mean((1, 3), keepdim=True)
    var = (x.square().mean((1, 3), keepdim=True) - mean.square()).clamp_min(0.0)
    mul = torch.rsqrt(var + norm.eps)
    if norm.affine:
        mul = mul * norm.weight.view(G, C // G)
    x = (x - mean) * mul
    if norm.affine:
        x = x + norm.bias.view(G, C // G)
    return x.reshape(B, T, C)


def _conv(conv: nn.Conv1d, x: torch.Tensor) -> torch.Tensor:
    """conv over x [B, T, C] in x's dtype (the weight and bias cast to it,
    the bias added after the product, as flax's ``nn.Conv(dtype=...)``)."""
    y = F.conv1d(x.transpose(1, 2), conv.weight.to(x.dtype), stride=conv.stride,
                 groups=conv.groups).transpose(1, 2)
    return y if conv.bias is None else y + conv.bias.to(x.dtype)


class GumbelQuantizer(nn.Module):
    """vq-wav2vec's Gumbel quantizer in eval (wav2vec1.py:64-114): logits by
    ``weight_proj`` (a Linear, or with depth > 1 blocks of Linear + ReLU at
    twice the input width, then a Linear) in f32, the argmax code of each
    group, its codeword from ``vars`` [1, groups (or 1 with
    ``combine_groups``) x num_vars, vq_dim / groups] in x's dtype. Train
    mode draws a "gumbel" stream that the JAX trainer never supplies: it
    raises (`upstream.base.train_refusal`)."""

    def __init__(self, dim: int, num_vars: int, groups: int, vq_dim: int,
                 combine_groups: bool = False, depth: int = 1, device=None):
        super().__init__()
        self.num_vars, self.groups = num_vars, groups
        self.combine_groups = combine_groups
        num_groups = 1 if combine_groups else groups
        self.vars = nn.Parameter(torch.empty(1, num_groups * num_vars, vq_dim // groups,
                                             device=device))
        if depth == 1:
            self.weight_proj = Dense(dim, groups * num_vars, device=device)
        else:
            inner = 2 * dim  # weight_proj_factor 2 (wav2vec_model.py:611)
            blocks = [nn.Sequential(Dense(dim if i == 0 else inner, inner, device=device),
                                    nn.ReLU()) for i in range(depth - 1)]
            self.weight_proj = nn.Sequential(*blocks, Dense(inner, groups * num_vars,
                                                            device=device))

    @torch.no_grad()
    def reset_parameters(self, generator=None) -> None:
        """flax's init of ``vars``: U[0, 1) (drawn on the CPU)."""
        self.vars.copy_(torch.rand(self.vars.shape, generator=generator))

    def forward(self, x: torch.Tensor):
        """x [B, T, C] -> (codewords [B, T, vq_dim] in x's dtype, codes [B, T, G])."""
        if self.training:
            raise NotImplementedError(
                "train mode of the Gumbel quantizer draws a \"gumbel\" PRNG stream that the "
                "JAX package's trainer never supplies (s3prl_tpu/models/wav2vec1.py:96-105); "
                "its train mode raises InvalidRngError: run it in eval()")
        B, T, _ = x.shape
        G, V = self.groups, self.num_vars
        logits = self.weight_proj(x).view(B, T, G, V)
        codes = logits.argmax(-1)
        codebook = self.vars[0].view(-1, V, self.vars.shape[-1])
        if self.combine_groups:
            codebook = codebook.expand(G, -1, -1)
        q = codebook[torch.arange(G, device=x.device), codes]  # [B, T, G, D]
        return q.reshape(B, T, -1).to(x.dtype), codes


class KmeansQuantizer(nn.Module):
    """vq-wav2vec's k-means quantizer (wav2vec1.py:117-153): the grouped 1x1
    ``projection.0`` (no bias) and the f32 GroupNorm ``projection.1`` (one
    group a codebook group) in f32, cast to x's dtype; each group's nearest
    codeword of ``embedding`` [num_vars, groups (or 1), vq_dim / groups] by
    the L2 distance in f32 (the lower index on a tie), then ze + (zq - ze)
    in x's dtype, as the straight-through form rounds it."""

    def __init__(self, dim: int, num_vars: int, groups: int, vq_dim: int,
                 combine_groups: bool = False, device=None):
        super().__init__()
        self.num_vars, self.groups = num_vars, groups
        num_groups = 1 if combine_groups else groups
        self.embedding = nn.Parameter(torch.empty(num_vars, num_groups, vq_dim // groups,
                                                  device=device))
        self.projection = nn.Sequential(
            nn.Conv1d(dim, dim, 1, groups=groups, bias=False, device=device),
            nn.GroupNorm(groups, dim, device=device))

    @torch.no_grad()
    def reset_parameters(self, generator=None) -> None:
        """flax's init of ``embedding``: normal(0.01) (drawn on the CPU)."""
        self.embedding.copy_(torch.randn(self.embedding.shape, generator=generator) * 0.01)

    def forward(self, x: torch.Tensor):
        B, T, C = x.shape
        G = self.groups
        ze = group_norm(_conv(self.projection[0], x.float()), self.projection[1]).to(x.dtype)
        emb = self.embedding.transpose(0, 1).expand(G, -1, -1)  # [G, V, D]
        ze_g = ze.float().reshape(B * T, G, -1).transpose(0, 1)  # [G, BT, D]
        d = torch.cdist(ze_g, emb, compute_mode="donot_use_mm_for_euclid_dist")
        codes = d.argmin(-1).transpose(0, 1).reshape(B, T, G)
        zq = emb[torch.arange(G, device=x.device), codes].reshape(B, T, C)
        return ze + (zq.to(ze.dtype) - ze), codes


class Wav2Vec1Model(nn.Module):
    """(wavs [B, T], wav_lens [B]) -> (hidden states [A + 1, B, T', C] in
    the model dtype, feat_lens [B]) (+ the quantizer's codes [B, T', G]
    with ``return_code_ids``)."""

    def __init__(self, cfg: Wav2Vec1Config = Wav2Vec1Config(), dtype=torch.float32, device=None):
        super().__init__()
        self.cfg, self.dtype = cfg, dtype
        affine = not cfg.non_affine_group_norm
        self.feature_extractor = nn.Module()
        self.feature_extractor.conv_layers = nn.ModuleList(
            nn.Sequential(nn.Conv1d(c_in, dim, k, s, bias=False, device=device), nn.Identity(),
                          nn.GroupNorm(1, dim, affine=affine, device=device))
            for c_in, (dim, k, s) in zip(
                (1,) + tuple(d for d, _, _ in cfg.conv_feature_layers), cfg.conv_feature_layers))
        z_dim = cfg.conv_feature_layers[-1][0]
        vq_dim = cfg.vq_dim if cfg.vq_dim > 0 else z_dim
        self.vector_quantizer = None
        if cfg.vq_type == "gumbel":
            self.vector_quantizer = GumbelQuantizer(z_dim, cfg.vq_vars, cfg.vq_groups, vq_dim,
                                                    cfg.combine_groups, cfg.vq_depth, device)
        elif cfg.vq_type == "kmeans":
            self.vector_quantizer = KmeansQuantizer(z_dim, cfg.vq_vars, cfg.vq_groups, vq_dim,
                                                    cfg.combine_groups, device)
        elif cfg.vq_type != "none":
            raise ValueError(f"vq_type {cfg.vq_type!r}: 'none', 'gumbel' or 'kmeans'")
        agg_in = (vq_dim if self.vector_quantizer is not None else z_dim,) + tuple(
            d for d, _, _ in cfg.conv_aggregator_layers)
        self.feature_aggregator = nn.Module()
        self.feature_aggregator.conv_layers = nn.ModuleList(
            nn.Sequential(nn.Identity(), nn.Conv1d(c_in, dim, k, s, bias=cfg.conv_bias,
                                                   device=device),
                          nn.Identity(), nn.GroupNorm(1, dim, affine=affine, device=device))
            for c_in, (dim, k, s) in zip(agg_in, cfg.conv_aggregator_layers))
        if cfg.skip_connections_agg:
            self.feature_aggregator.residual_proj = nn.ModuleList(
                nn.Conv1d(c_in, dim, 1, bias=False, device=device) if c_in != dim else None
                for c_in, (dim, _, _) in zip(agg_in, cfg.conv_aggregator_layers))

    def feat_lengths(self, wav_lens: torch.Tensor) -> torch.Tensor:
        for _, k, s in self.cfg.conv_feature_layers:
            wav_lens = lengths_after_conv1d(wav_lens, k, s)
        return wav_lens

    def _states(self, wavs: torch.Tensor, generator, codes: list) -> torch.Tensor:
        cfg = self.cfg
        x = wavs[..., None].to(self.dtype)
        for layer in self.feature_extractor.conv_layers:
            residual = x
            x = F.relu(group_norm(_conv(layer[0], x), layer[2]).to(self.dtype))
            if cfg.skip_connections_feat and residual.shape[-1] == x.shape[-1]:
                stride = residual.shape[1] // x.shape[1]
                x = (x + residual[:, ::stride][:, :x.shape[1]]) * cfg.residual_scale ** 0.5
        if cfg.log_compression:
            x = torch.log(x.abs() + 1.0)
        hidden = [x]  # z
        if self.vector_quantizer is not None:
            x, ids = self.vector_quantizer(x)
            codes.append(ids)
        scale = cfg.residual_scale ** 0.5
        for i, layer in enumerate(self.feature_aggregator.conv_layers):
            if i > 0:
                hidden.append(x)
            residual = x
            k = layer[1].kernel_size[0]
            xp = F.pad(x.transpose(1, 2), (k - 1, 0),
                       mode="constant" if cfg.agg_zero_pad else "replicate").transpose(1, 2)
            x = dropout(_conv(layer[1], xp), cfg.dropout, self.training, generator)
            x = F.relu(group_norm(x, layer[3]).to(self.dtype))
            if cfg.skip_connections_agg:
                proj = self.feature_aggregator.residual_proj[i]
                if proj is not None:
                    residual = _conv(proj, residual)
                x = (x + residual) * scale
        hidden.append(x)  # c
        return torch.stack(hidden)

    def forward(self, wavs: torch.Tensor, wav_lens: torch.Tensor, generator=None,
                return_code_ids: bool = False):
        codes: list = []
        hs = ieee_call(lambda w: self._states(w, generator, codes), wavs, self.parameters())
        if return_code_ids:
            return hs, self.feat_lengths(wav_lens), codes[0] if codes else None
        return hs, self.feat_lengths(wav_lens)
