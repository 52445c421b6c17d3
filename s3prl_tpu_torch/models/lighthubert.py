"""LightHuBERT (port of s3prl_tpu/models/lighthubert.py): a fixed subnet of
the once-for-all HuBERT supernet, which is a plain trunk whose weights are
the supernet's sliced on the host (`upstream.convert.load_lighthubert_
checkpoint`).

Every wave is normalised (the reference expert layer-norms each input),
then the layer-norm extractor (K3 on layer 0 in eval mode, as in the
HuBERT-Large trunk), HuBERT's block length rule, the f32 LayerNorm, the
projection to the subnet's width and a post-LN encoder with the pos-conv
(head dim 64: 640 wide with 10 heads in the base subnet, 384 with 6 in the
small one). The hidden states are [projected features (before the
pos-conv), each layer's output], L + 1 of them (lighthubert.py:64-93). The
dropouts are 0, so train mode is eval mode's arithmetic.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Tuple

import torch
import torch.nn as nn
import torch.nn.functional as F

from .convfe import DEFAULT_CONV_LAYERS, ConvFeatureExtractor
from .transformer import TransformerEncoder
from .wav2vec2 import normalize_wavs

# the published subnets (lighthubert.py:34-37)
SUBNET_BASE = {"embed_dim": 640, "heads_num": 10, "ffn_embed": 2560, "layer_num": 12}
SUBNET_SMALL = {"embed_dim": 384, "heads_num": 6, "ffn_embed": 1536, "layer_num": 12}
SUBNET_BASE_MAX = {"embed_dim": 768, "heads_num": 12, "ffn_embed": 3072, "layer_num": 12}
SUBNET_SMALL_MAX = {"embed_dim": 512, "heads_num": 8, "ffn_embed": 2048, "layer_num": 12}


@dataclass(frozen=True)
class LightHubertConfig:
    """The field names and defaults of s3prl_tpu.models.lighthubert.LightHubertConfig."""

    conv_feature_layers: Tuple[Tuple[int, int, int], ...] = DEFAULT_CONV_LAYERS
    extractor_mode: str = "layer_norm"
    conv_bias: bool = False
    embed_dim: int = 640
    num_heads: int = 10
    ffn_dim: int = 2560
    num_layers: int = 12
    conv_pos: int = 128
    conv_pos_groups: int = 16
    layer_norm_first: bool = False

    @classmethod
    def of_subnet(cls, subnet: dict, **fields) -> "LightHubertConfig":
        return cls(embed_dim=subnet["embed_dim"], num_heads=subnet["heads_num"],
                   ffn_dim=subnet["ffn_embed"], num_layers=subnet["layer_num"], **fields)


class LightHubertModel(nn.Module):
    """(wavs [B, T], wav_lens [B]) -> (hidden states [L + 1, B, T', E],
    feat_lens [B]). Matrix weights in `dtype`, biases and norms in f32."""

    def __init__(self, cfg: LightHubertConfig, dtype: torch.dtype = torch.float32,
                 device=None):
        super().__init__()
        self.cfg, self.dtype = cfg, dtype
        self.feature_extractor = ConvFeatureExtractor(cfg.conv_feature_layers, cfg.extractor_mode,
                                                      cfg.conv_bias, dtype, device=device)
        embed = cfg.conv_feature_layers[-1][0]
        self.layer_norm = nn.LayerNorm(embed, device=device)
        self.post_extract_proj = nn.Linear(embed, cfg.embed_dim, device=device)
        self.post_extract_proj.weight.data = self.post_extract_proj.weight.data.to(dtype)
        self.encoder = TransformerEncoder(
            cfg.embed_dim, cfg.ffn_dim, cfg.num_layers, cfg.num_heads, cfg.layer_norm_first,
            cfg.conv_pos, cfg.conv_pos_groups, dtype, device=device)

    def forward(self, wavs: torch.Tensor, wav_lens: torch.Tensor, generator=None):
        wavs = normalize_wavs(wavs, wav_lens)
        feat = self.feature_extractor(wavs)
        t_feat = feat.shape[1]
        r = max(wavs.shape[1] // max(t_feat, 1), 1)  # HuBERT's block rule
        feat_lens = torch.clamp(torch.div(wav_lens + r - 1, r, rounding_mode="floor"), max=t_feat)
        feat = F.layer_norm(feat.float(), self.layer_norm.normalized_shape,
                            self.layer_norm.weight, self.layer_norm.bias, eps=1e-5)
        proj = self.post_extract_proj
        x = F.linear(feat.to(self.dtype), proj.weight, proj.bias.to(self.dtype))
        hs = self.encoder(x, feat_lens)
        return torch.cat([x[None], hs[1:]]), feat_lens
