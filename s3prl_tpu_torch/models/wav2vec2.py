"""wav2vec 2.0 / HuBERT trunk (port of s3prl_tpu/models/wav2vec2.py): waveform
-> strided conv features -> f32 LayerNorm -> projection to the encoder width
-> conv-pos-emb transformer, returning [L+1, B, T', C] hidden states and the
valid frame count of each utterance.

Ported for serving (f32, bf16, and int8 W8A8 with ``quantize``): the
layer-norm extractor with a pre-LN encoder (HuBERT-Large, wav2vec2-Large)
or a post-LN one (data2vec), the group-norm extractor with a post-LN
encoder (HuBERT-Base, wav2vec2-Base); HuBERT's block-folded feature-length
rule and wav2vec2's / data2vec's conv rule (``feat_pad_rule="conv"``: the
strict conv arithmetic, which gives 0 frames below 400 samples); the one
pos-conv and data2vec's depth > 1 stack; the Conformer encoder
(``layer_type="conformer"``: rel-pos or rotary ESPnet attention, no
pos-conv, stock ops; eval only); the FFN activations gelu, relu and swish
(``activation_fn``; the kernels' FFNs serve gelu only, `EncoderLayer`);
the fused weighted sum of the layers (``layer_weights``); train mode's
dropouts from an explicit generator; pretraining's span mask (``mask_indices``:
the frames replaced by ``mask_emb``). No layerdrop (`Upstream` refuses it in
train mode, as the JAX trainer's missing stream does). WavLM
(`models/wavlm.py`) is this trunk with its own encoder and an erf extractor.
The module names follow fairseq's state_dict keys (see upstream/convert.py).
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Tuple

import torch
import torch.nn as nn
import torch.nn.functional as F

from ..kernels import flash_attention as fa
from ..nn.heads import dropout
from ..ops.masking import length_mask
from .convfe import (DEFAULT_CONV_LAYERS, ConvFeatureExtractor, conv_output_lengths,
                     total_stride)
from .transformer import (ACTIVATIONS, ConvPositionalEmbedding, ConvPositionalStack,
                          EncoderLayer, TransformerEncoder, on_card)


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
    feat_pad_rule: str = "block"  # "block" (hubert) | "conv" (data2vec) | "hf" (`hf_frames`)
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


def _unsupported(cfg: Wav2Vec2Config, layer_types, activations) -> str | None:
    if cfg.layer_type not in layer_types:
        return f"layer_type {cfg.layer_type!r}"
    if cfg.activation_fn not in activations:
        return f"activation_fn {cfg.activation_fn!r}"
    return None


def card_refusal(cfg: Wav2Vec2Config, use_flash: bool, posconv: str | None) -> None:
    """Raises the ValueError of a model the card's kernels cannot serve,
    before anything is allocated: ``use_flash`` at a head dim other than
    the attention kernels' HEAD_DIM, and a pos-conv option whose kernel
    cannot take the pos-conv (`ConvPositionalEmbedding.card_refusal`). A
    model built on the CPU runs both (the kernels' plain versions)."""
    if use_flash:
        C, H = cfg.encoder_embed_dim, cfg.encoder_attention_heads
        if C % H or C // H != fa.HEAD_DIM:
            raise ValueError(f"flash=True cannot take effect on the card: its attention kernels "
                             f"take head dim {fa.HEAD_DIM}, got {C} channels in {H} heads")
    if posconv is not None and cfg.pos_conv_depth == 1:
        ConvPositionalEmbedding.card_refusal(cfg.encoder_embed_dim, cfg.conv_pos,
                                             cfg.conv_pos_groups, posconv)


def hf_frames(wav_lens: torch.Tensor, conv_layers, t_feat: int) -> torch.Tensor:
    """The valid frames of transformers' wav2vec2 attention mask
    (``_get_feature_vector_attention_mask``): the conv arithmetic
    floor((L - k) / s) + 1 without a floor at 0, then the frames up to the
    index n - 1 read as a Python index (n <= 0 counts from the end: a wave
    too short for one frame attends to all t_feat of them)."""
    n = wav_lens
    for _, k, s in conv_layers:
        n = torch.div(n - k, s, rounding_mode="floor") + 1
    return torch.remainder(n - 1, t_feat) + 1


class Wav2Vec2Trunk(nn.Module):
    """Conv features -> LayerNorm -> proj -> transformer (extraction only).

    Matrix weights are created in `dtype`, biases and norms in f32; with
    ``quantize`` (int8 W8A8 serving: tanh GELU in the extractor, int8
    encoder projections) the encoder's matrix weights stay f32 and are
    quantized once by `build_qcache`. Build on ``device="meta"`` and
    materialise with ``to_empty`` when the weights come from an initialiser
    or a state_dict.

    Options, all off by default: the fused int8 projections of the encoder
    layers (`fuse_options`) and the front-end options of the extractor
    (`ConvFeatureExtractor`): ``int8_conv`` (K13a + K13b, needs
    ``quantize``; HuBERT only, as WavLM's extractor takes no ``quantize``),
    ``fused_conv`` (K3 erf + K14) and ``fused_midln`` (K15); and the pos-conv
    options of the encoder (`ConvPositionalEmbedding`, in every dtype, as the
    JAX switch is independent of ``quantize``): ``fused_posconv`` (K16a) and
    ``int8_posconv`` (K16b, its weight kept f32). One that cannot take effect
    raises a ValueError before any weight is made: the front-end options on
    the group-norm extractor, ``qkv_fuse`` / ``full_fuse`` on post-LN blocks,
    the pos-conv options on data2vec's depth > 1 stack and on the Conformer
    encoder (no pos-conv), ``flash=True`` on conformer layers (their ESPnet
    attention runs no kernel).
    Built on a CUDA device, the trunk also refuses what the card's kernels
    cannot take (`card_refusal`): ``use_flash`` at a head dim other than 64,
    a pos-conv option at other than 64 channels a group."""

    # int8 serving runs the extractor's GELU in tanh (s3prl_tpu/models/
    # wav2vec2.py passes ``quantize`` to its extractor; WavLM's does not)
    tanh_extractor = True
    # the fused int8 projection options its encoder layers take (off by
    # default, as the JAX package's QKV-fuse and full-fuse switches)
    fuse_options = ("qkv_fuse", "full_fuse")
    # the encoder layers it builds (WavLM's encoder has transformer layers only)
    layer_types = ("transformer", "conformer")
    # the transformer layers' FFN activations (fairseq's activation_fn)
    activations = tuple(ACTIVATIONS)

    def __init__(self, cfg: Wav2Vec2Config, dtype: torch.dtype = torch.float32,
                 use_flash: bool = False, quantize: bool = False, device=None,
                 qkv_fuse: bool = False, full_fuse: bool = False, wavlm_fuse: bool = False,
                 int8_conv: bool = False, fused_conv: bool = False, fused_midln: bool = False,
                 fused_posconv: bool = False, int8_posconv: bool = False):
        super().__init__()
        reason = _unsupported(cfg, self.layer_types, self.activations)
        if reason is not None:
            raise NotImplementedError(f"{reason} is not ported in {type(self).__name__}")
        if fused_posconv and int8_posconv:
            raise ValueError("fused_posconv and int8_posconv: the pos-conv takes one kernel "
                             "(the JAX package's pos-conv switch has one value)")
        posconv = "fused" if fused_posconv else "int8" if int8_posconv else None
        if cfg.layer_type == "conformer" and use_flash:
            raise ValueError("flash=True cannot take effect on conformer layers: their ESPnet "
                             "attention runs no kernel (the JAX package ignores use_flash there)")
        if cfg.layer_type == "conformer" and posconv is not None:
            raise ValueError(f"{'fused_posconv' if posconv == 'fused' else 'int8_posconv'} "
                             "cannot take effect: the Conformer encoder has no pos-conv")
        ConvPositionalStack.refuse_option(cfg.pos_conv_depth, posconv)
        options = {"qkv_fuse": qkv_fuse, "full_fuse": full_fuse, "wavlm_fuse": wavlm_fuse}
        on = [name for name, value in options.items() if value]
        foreign = [name for name in on if name not in self.fuse_options]
        if foreign:
            raise ValueError(f"{', '.join(foreign)} cannot take effect in "
                             f"{type(self).__name__}, whose layers take "
                             f"{' and '.join(self.fuse_options)}")
        if on and not (quantize and use_flash):
            raise ValueError(f"{', '.join(on)} fuses projections of int8 serving: "
                             "it needs quantize=True and flash=True")
        EncoderLayer.refuse_options(cfg.layer_norm_first, qkv_fuse, full_fuse)
        if on_card(device):
            card_refusal(cfg, use_flash, posconv)
        self.cfg = cfg
        self.dtype = dtype
        self.feature_extractor = ConvFeatureExtractor(
            cfg.conv_feature_layers, cfg.extractor_mode, cfg.conv_bias, dtype,
            quantize and self.tanh_extractor, device=device, int8_conv=int8_conv,
            fused_conv=fused_conv, fused_midln=fused_midln)
        embed = cfg.conv_feature_layers[-1][0]
        self.layer_norm = nn.LayerNorm(embed, device=device)
        self.post_extract_proj = None
        if cfg.post_extract_proj_always or embed != cfg.encoder_embed_dim:
            self.post_extract_proj = nn.Linear(embed, cfg.encoder_embed_dim, device=device)
            self.post_extract_proj.weight.data = self.post_extract_proj.weight.data.to(dtype)
        # pretraining's mask embedding (`forward`'s ``mask_indices``); kept in
        # extraction so the state_dict carries the whole checkpoint
        self.mask_emb = nn.Parameter(torch.empty(cfg.encoder_embed_dim, device=device))
        self.encoder = self._encoder(cfg, dtype, use_flash, quantize, device, posconv,
                                     **{name: options[name] for name in self.fuse_options})

    def _encoder(self, cfg, dtype, use_flash, quantize, device, posconv, **fuse) -> nn.Module:
        return TransformerEncoder(
            cfg.encoder_embed_dim, cfg.encoder_ffn_embed_dim, cfg.encoder_layers,
            cfg.encoder_attention_heads, cfg.layer_norm_first, cfg.conv_pos,
            cfg.conv_pos_groups, dtype, use_flash, quantize, device=device, posconv=posconv,
            pos_conv_depth=cfg.pos_conv_depth, dropout=cfg.dropout,
            activation_dropout=cfg.activation_dropout, layer_type=cfg.layer_type,
            pos_enc_type=cfg.pos_enc_type, depthwise_kernel=cfg.depthwise_conv_kernel_size,
            activation=cfg.activation_fn, **fuse)

    def build_qcache(self) -> None:
        """Quantizes every encoder layer's projections once from their f32
        weights (a no-op without ``quantize``) and builds the extractor's
        front-end option weights (a no-op without ``int8_conv`` or
        ``fused_conv``) and the pos-conv option's (a no-op without
        ``fused_posconv`` or ``int8_posconv``)."""
        self.feature_extractor.build_qcache()
        if self.encoder.pos_conv is not None:
            self.encoder.pos_conv.build_qcache()
        for layer in self.encoder.layers:
            if layer.quantize:
                layer.build_qcache()

    def forward(self, wavs: torch.Tensor, wav_lens: torch.Tensor,
                layer_weights: torch.Tensor | None = None, generator=None,
                mask_indices: torch.Tensor | None = None, sp=None):
        """wavs [B, T] padded 16 kHz, wav_lens [B] -> (hidden_states
        [L+1, B, T', C], feat_lens [B]); with ``layer_weights`` [L+1] on the
        model's device, hidden_states is their weighted sum [1, B, T', C]
        (wav2vec2.py:115, :197; `TransformerEncoder.forward`). In train mode
        the dropouts (``dropout_input`` after the projection, wav2vec2.py:149,
        then the encoder's) draw from `generator`. ``mask_indices`` [B, T'']
        bool (pretraining) puts ``mask_emb`` on its True frames after
        ``dropout_input``, cut or padded with False to T' (wav2vec2.py:
        159-171). `sp` (`parallel.mesh.TimeShard`, time-sharded extraction
        in eval mode): the frames [lo, hi) of the whole T' from the full
        waves, whose length rules it keeps."""
        cfg = self.cfg
        if cfg.normalize:
            wavs = normalize_wavs(wavs, wav_lens)
        if sp is None:
            features = self.feature_extractor(wavs)
            t_feat = features.shape[1]
        else:
            features, t_feat = sp.extract(self.feature_extractor, wavs), sp.total
        if cfg.feat_pad_rule == "conv":  # strict conv arithmetic (wav2vec2.py:133-137)
            feat_lens = torch.clamp(conv_output_lengths(wav_lens, cfg.conv_feature_layers),
                                    max=t_feat)
        elif cfg.feat_pad_rule == "hf":
            feat_lens = hf_frames(wav_lens, cfg.conv_feature_layers, t_feat)
        else:
            # hubert's padding rule (hubert_model.py:459-469): a frame is padded
            # only when all of its r = T_wav // T_feat samples are, so
            # ceil(wav_len / r) frames are valid (wav2vec2.py:138-140)
            r = max(wavs.shape[1] // max(t_feat, 1), 1)
            feat_lens = torch.clamp(torch.div(wav_lens + r - 1, r, rounding_mode="floor"),
                                    max=t_feat)
        features = F.layer_norm(features.float(), self.layer_norm.normalized_shape,
                                self.layer_norm.weight, self.layer_norm.bias, eps=1e-5)
        features = features.to(self.dtype)
        if self.post_extract_proj is not None:
            proj = self.post_extract_proj
            features = F.linear(features, proj.weight, proj.bias.to(self.dtype))
        features = dropout(features, cfg.dropout_input, self.training, generator)
        if mask_indices is not None:
            t = features.shape[1]
            mask = F.pad(mask_indices[:, :t], (0, max(t - mask_indices.shape[1], 0)))
            features = torch.where(mask.to(features.device)[..., None],
                                   self.mask_emb.to(features.dtype), features)
        extra = {} if sp is None else {"sp": sp}
        return self.encoder(features, feat_lens, layer_weights, generator, **extra), feat_lens


class HfWav2Vec2(Wav2Vec2Trunk):
    """transformers' wav2vec2 (and HuBERT) as the JAX ``hf_*`` entries run
    it (registry.py:920-972): a trunk of `convert_hf.hf_config`'s config
    (pre-LN, the layer-norm extractor, the HF mask's frames), whose modules
    stay in eval mode under ``train()`` too, as the JAX entry applies its
    model with ``train=False``; the lengths it returns are the JAX entry's
    min(ceil(len / r), T'), r = T // T'. The layer-norm extractor without a
    conv bias runs K3 `conv0_ln_gelu` (erf) once a forward."""

    def train(self, mode: bool = True):
        self.training = mode
        for child in self.children():
            child.train(False)
        return self

    def forward(self, wavs: torch.Tensor, wav_lens: torch.Tensor, generator=None):
        hs, _ = super().forward(wavs, wav_lens)
        t_feat = hs.shape[2]
        r = max(wavs.shape[1] // max(t_feat, 1), 1)
        return hs, torch.clamp(torch.div(wav_lens + r - 1, r, rounding_mode="floor"), max=t_feat)
