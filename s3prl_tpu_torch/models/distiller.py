"""DistilHuBERT (port of s3prl_tpu/models/distiller.py): the group-norm conv
extractor -> projection to 768 -> a two-layer post-LN transformer -> the
prediction heads (Linear(768 -> inter * n_tasks) -> erf GELU -> per-task
`SplitLinear` -> final_dim) that regress the teacher's layers.

The hidden states are [projected features, each layer's output, the n_tasks
predictions], 1 + L + n_tasks of them (distiller.py:90-125); the feature
lengths follow the strict conv arithmetic (:85-90). The module names follow
the reference's state_dict keys (``output_layer.0`` the expansion,
``output_layer.2`` the SplitLinear). Stock ops only: the group-norm
extractor and the post-LN layers without ``use_flash`` run no kernel, as in
the JAX package. In train mode the encoder's dropouts draw from the
forward's generator (the JAX model has no input dropout).
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Tuple

import torch
import torch.nn as nn
import torch.nn.functional as F

from .convfe import (DEFAULT_CONV_LAYERS, ConvFeatureExtractor, conv_output_lengths,
                     total_stride)
from .transformer import TransformerEncoder


@dataclass(frozen=True)
class DistillerConfig:
    """The field names and defaults of s3prl_tpu.models.distiller.DistillerConfig."""

    conv_feature_layers: Tuple[Tuple[int, int, int], ...] = DEFAULT_CONV_LAYERS
    extractor_mode: str = "default"
    encoder_layers: int = 2
    encoder_embed_dim: int = 768
    encoder_ffn_embed_dim: int = 3072
    encoder_attention_heads: int = 12
    layer_norm_first: bool = False
    conv_pos: int = 128
    conv_pos_groups: int = 16
    dropout: float = 0.1
    attention_dropout: float = 0.1
    activation_dropout: float = 0.1
    final_dim: int = 768
    n_tasks: int = 12
    out_layer_inter_dim: int = -1  # -1 -> encoder_embed_dim

    @property
    def downsample_rate(self) -> int:
        return total_stride(self.conv_feature_layers)

    @property
    def inter_dim(self) -> int:
        return self.out_layer_inter_dim if self.out_layer_inter_dim > 0 else self.encoder_embed_dim


class SplitLinear(nn.Module):
    """A linear map per task on its slice (the reference's SplitLinear):
    [B, T, n * inter] -> [B, T, n, out]; ``weight`` [n, inter, out] and
    ``bias`` [1, 1, n, out] in the reference's shapes."""

    def __init__(self, inter_dim: int, n_tasks: int, out_dim: int, device=None):
        super().__init__()
        self.weight = nn.Parameter(torch.empty(n_tasks, inter_dim, out_dim, device=device))
        self.bias = nn.Parameter(torch.empty(1, 1, n_tasks, out_dim, device=device))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        B, T, _ = x.shape
        n, inter, _ = self.weight.shape
        x = x.view(B, T, n, inter)
        return torch.einsum("btni,nio->btno", x, self.weight.to(x.dtype)) + self.bias.to(x.dtype)


class DistillerModel(nn.Module):
    """(wavs [B, T], wav_lens [B]) -> (hidden states [1 + L + n_tasks, B,
    T', C], feat_lens [B]). Matrix weights in `dtype`, biases and norms in
    f32."""

    def __init__(self, cfg: DistillerConfig, dtype: torch.dtype = torch.float32, device=None):
        super().__init__()
        self.cfg, self.dtype = cfg, dtype
        C = cfg.encoder_embed_dim
        self.feature_extractor = ConvFeatureExtractor(cfg.conv_feature_layers, cfg.extractor_mode,
                                                      False, dtype, device=device)
        self.post_extract_proj = None
        if cfg.conv_feature_layers[-1][0] != C:
            self.post_extract_proj = nn.Linear(cfg.conv_feature_layers[-1][0], C, device=device)
        self.encoder = TransformerEncoder(
            C, cfg.encoder_ffn_embed_dim, cfg.encoder_layers, cfg.encoder_attention_heads,
            cfg.layer_norm_first, cfg.conv_pos, cfg.conv_pos_groups, dtype, device=device,
            dropout=cfg.dropout, activation_dropout=cfg.activation_dropout)
        self.output_layer = nn.Sequential(
            nn.Linear(C, cfg.inter_dim * cfg.n_tasks, device=device), nn.GELU(),
            SplitLinear(cfg.inter_dim, cfg.n_tasks, cfg.final_dim, device=device))
        for m in (self.post_extract_proj, self.output_layer[0], self.output_layer[2]):
            if m is not None:
                m.weight.data = m.weight.data.to(dtype)

    def forward(self, wavs: torch.Tensor, wav_lens: torch.Tensor, generator=None):
        cfg = self.cfg
        feat = self.feature_extractor(wavs)
        feat_lens = torch.clamp(conv_output_lengths(wav_lens, cfg.conv_feature_layers),
                                max=feat.shape[1])
        if self.post_extract_proj is not None:
            proj = self.post_extract_proj
            feat = F.linear(feat, proj.weight, proj.bias.to(self.dtype))
        hs = self.encoder(feat, feat_lens, generator=generator)
        expand = self.output_layer[0]
        x = F.gelu(F.linear(hs[-1], expand.weight, expand.bias.to(self.dtype)))
        preds = self.output_layer[2](x).permute(2, 0, 1, 3)  # [n_tasks, B, T', D]
        return torch.cat([feat[None], hs[1:], preds]), feat_lens
