"""wav2vec 2.0 / HuBERT trunk (port of s3prl_tpu/models/wav2vec2.py): waveform
-> strided conv features -> f32 LayerNorm -> projection to the encoder width
-> conv-pos-emb transformer, returning [L+1, B, T', C] hidden states and the
valid frame count of each utterance.

Ported for the HuBERT-Large serving slice: layer-norm extractor, pre-LN
encoder, the block-folded feature-length rule, no span masking (extraction).
The module names follow fairseq's state_dict keys (see upstream/convert.py).
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Tuple

import torch
import torch.nn as nn
import torch.nn.functional as F

from ..ops.masking import length_mask
from .convfe import DEFAULT_CONV_LAYERS, ConvFeatureExtractor, total_stride
from .transformer import TransformerEncoder


@dataclass(frozen=True)
class Wav2Vec2Config:
    """Architecture hyperparameters; the field names are those of
    s3prl_tpu.models.wav2vec2.Wav2Vec2Config."""

    extractor_mode: str = "default"  # "default" (Base) | "layer_norm" (Large)
    conv_feature_layers: Tuple[Tuple[int, int, int], ...] = DEFAULT_CONV_LAYERS
    conv_bias: bool = False
    encoder_layers: int = 12
    encoder_embed_dim: int = 768
    encoder_ffn_embed_dim: int = 3072
    encoder_attention_heads: int = 12
    activation_fn: str = "gelu"
    layer_norm_first: bool = False
    conv_pos: int = 128
    conv_pos_groups: int = 16
    pos_conv_depth: int = 1
    dropout: float = 0.1
    attention_dropout: float = 0.1
    activation_dropout: float = 0.0
    dropout_input: float = 0.1
    encoder_layerdrop: float = 0.0
    layer_type: str = "transformer"
    pos_enc_type: str = "rel_pos"
    depthwise_conv_kernel_size: int = 31
    post_extract_proj_always: bool = False
    feat_pad_rule: str = "block"  # "block" (hubert) | "conv" (data2vec)
    normalize: bool = False  # per-utterance wave normalisation (Large models)

    @property
    def downsample_rate(self) -> int:
        return total_stride(self.conv_feature_layers)


BASE = Wav2Vec2Config()
LARGE = Wav2Vec2Config(
    extractor_mode="layer_norm",
    encoder_layers=24,
    encoder_embed_dim=1024,
    encoder_ffn_embed_dim=4096,
    encoder_attention_heads=16,
    layer_norm_first=True,
    dropout=0.0,
    attention_dropout=0.0,
    normalize=True,
)


def normalize_wavs(wavs: torch.Tensor, wav_lens: torch.Tensor) -> torch.Tensor:
    """Per-utterance zero-mean unit-variance over the valid samples (masked
    biased mean/var, eps 1e-5), padding left at zero."""
    B, T = wavs.shape
    mask = length_mask(wav_lens, T, wavs.dtype)
    denom = torch.clamp(wav_lens.to(wavs.dtype), min=1.0)[:, None]
    mean = (wavs * mask).sum(1, keepdim=True) / denom
    var = torch.where(mask > 0, (wavs - mean) ** 2, 0.0).sum(1, keepdim=True) / denom
    return (wavs - mean) / torch.sqrt(var + 1e-5) * mask


def _unsupported(cfg: Wav2Vec2Config) -> str | None:
    if cfg.layer_type != "transformer":
        return f"layer_type {cfg.layer_type!r}"
    if cfg.pos_conv_depth != 1:
        return f"pos_conv_depth {cfg.pos_conv_depth}"
    if cfg.feat_pad_rule != "block":
        return f"feat_pad_rule {cfg.feat_pad_rule!r}"
    if cfg.activation_fn != "gelu":
        return f"activation_fn {cfg.activation_fn!r}"
    return None


class Wav2Vec2Trunk(nn.Module):
    """Conv features -> LayerNorm -> proj -> transformer (extraction only).

    Matrix weights are created in `dtype`, biases and norms in f32. Build on
    ``device="meta"`` and materialise with ``to_empty`` when the weights come
    from an initialiser or a state_dict."""

    def __init__(self, cfg: Wav2Vec2Config, dtype: torch.dtype = torch.float32,
                 use_flash: bool = False, device=None):
        super().__init__()
        reason = _unsupported(cfg)
        if reason is not None:
            raise NotImplementedError(
                f"{reason} is not ported yet (ROADMAP.md Queue 1 items 5, 6, 11)")
        self.cfg = cfg
        self.dtype = dtype
        self.feature_extractor = ConvFeatureExtractor(
            cfg.conv_feature_layers, cfg.extractor_mode, cfg.conv_bias, dtype,
            device=device)
        embed = cfg.conv_feature_layers[-1][0]
        self.layer_norm = nn.LayerNorm(embed, device=device)
        self.post_extract_proj = None
        if cfg.post_extract_proj_always or embed != cfg.encoder_embed_dim:
            self.post_extract_proj = nn.Linear(embed, cfg.encoder_embed_dim, device=device)
            self.post_extract_proj.weight.data = self.post_extract_proj.weight.data.to(dtype)
        # pretraining's mask embedding: unused by extraction, kept so the
        # state_dict carries the whole checkpoint
        self.mask_emb = nn.Parameter(torch.empty(cfg.encoder_embed_dim, device=device))
        self.encoder = TransformerEncoder(
            cfg.encoder_embed_dim, cfg.encoder_ffn_embed_dim, cfg.encoder_layers,
            cfg.encoder_attention_heads, cfg.layer_norm_first, cfg.conv_pos,
            cfg.conv_pos_groups, dtype, use_flash, device=device)

    def forward(self, wavs: torch.Tensor, wav_lens: torch.Tensor):
        """wavs [B, T] padded 16 kHz, wav_lens [B] -> (hidden_states
        [L+1, B, T', C], feat_lens [B])."""
        if self.cfg.normalize:
            wavs = normalize_wavs(wavs, wav_lens)
        features = self.feature_extractor(wavs)
        # hubert's padding rule (hubert_model.py:459-469): a frame is padded
        # only when all of its r = T_wav // T_feat samples are, so
        # ceil(wav_len / r) frames are valid (wav2vec2.py:133-140)
        t_feat = features.shape[1]
        r = max(wavs.shape[1] // max(t_feat, 1), 1)
        feat_lens = torch.clamp(torch.div(wav_lens + r - 1, r, rounding_mode="floor"),
                                max=t_feat)
        features = F.layer_norm(features.float(), self.layer_norm.normalized_shape,
                                self.layer_norm.weight, self.layer_norm.bias, eps=1e-5)
        features = features.to(self.dtype)
        if self.post_extract_proj is not None:
            proj = self.post_extract_proj
            features = F.linear(features, proj.weight, proj.bias.to(self.dtype))
        return self.encoder(features, feat_lens), feat_lens
