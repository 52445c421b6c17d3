"""Named upstream registry (port of s3prl_tpu/upstream/registry.py).

Ported entries, with the JAX package's names and configurations
(s3prl_tpu/upstream/registry.py:211-240, :290-308, :481-520, :693-716,
:1524-1528):
- HuBERT: ``hubert_large_ll60k`` (pre-LN, layer-norm extractor), ``hubert``
  / ``hubert_base`` (post-LN, group-norm extractor) and the HuBERT-Base
  aliases ``hubert_base_robust_mgr``, ``mhubert_base_vp_en_es_fr_it3``,
  ``contentvec``, ``contentvec_km100``, ``contentvec_km500``, ``ms_hubert``;
- wav2vec 2.0 (the conv length rule): ``wav2vec2`` / ``wav2vec2_base_960``,
  ``wav2vec2_large_ll60k`` / ``wav2vec2_large_lv60_cv_swbd_fsh`` and the
  Large aliases ``wav2vec2_large_960``, ``wav2vec2_large_voxpopuli_100k``,
  ``xlsr_53``, ``xls_r_300m``, ``xls_r_1b``, ``xls_r_2b`` (their published
  shapes come with ``ckpt=``);
- data2vec (post-LN, layer-norm extractor, the conv rule, the depth-5
  pos-conv stack): ``data2vec`` / ``data2vec_base_960``,
  ``data2vec_large_ll60k``;
- WavLM: ``wavlm`` / ``wavlm_base``, ``wavlm_base_plus``, ``wavlm_large``,
  and UniSpeech-SAT, which shares them: ``unispeech_sat`` /
  ``unispeech_sat_base``, ``unispeech_sat_base_plus``,
  ``unispeech_sat_large``;
- the parameter-free baseline front ends (models/baseline.py: one layer,
  stride 160, f32 features computed on the model's device): ``fbank``,
  ``fbank_no_cmvn``, ``mfcc``, ``spectrogram``, ``mel``, ``linear``, which
  take ``device=`` and `baseline_features`' keywords and none of the
  trunks';
the trunks each in f32, bf16 and int8 W8A8 (``quantize=True``, the serving default),
the int8 path with its opt-in fused projections (``qkv_fuse``,
``full_fuse``; ``wavlm_fuse``), the front-end options ``int8_conv`` (HuBERT
int8), ``fused_conv`` and ``fused_midln``, and the pos-conv options
``fused_posconv`` and ``int8_posconv``, each where it can take effect
(`load`). The trunk entries (not WavLM / UniSpeech-SAT, as in the JAX
package) also serve the fused weighted sum, `TrunkUpstream.apply_weighted`.
A model is built on the card (``torch.device("cuda")``) unless
``device=`` says otherwise; without CUDA and without ``device=`` loading
raises rather than building on the CPU. With ``ckpt=`` (a local file:
`load_trunk_checkpoint`, `load_wavlm_checkpoint`) the configuration and
the weights come from the checkpoint; without one the weights are random,
drawn on the CPU from a `torch.Generator` seeded with `seed`, so one seed
gives the same model on every device. With ``quantize`` the encoder's
projections are quantized once, on the CPU from their f32 values, before
the model moves to its device (the JAX package's `_materialize_qcache`,
registry.py:117-148). Nothing is downloaded: ``download=True`` raises.
"""

from __future__ import annotations

import math
from dataclasses import replace
from typing import Callable, Dict, List

import torch
import torch.nn as nn

from ..models.baseline import BASELINE_CONFIGS, BaselineFeatures
from ..models.hubert import HUBERT_BASE, HUBERT_LARGE
from ..models.transformer import SelfAttention
from ..models.wav2vec2 import BASE, LARGE, Wav2Vec2Config, Wav2Vec2Trunk, card_refusal
from ..models.wavlm import (WAVLM_BASE, WAVLM_BASE_PLUS, WAVLM_LARGE, GatedSelfAttention,
                            WavLMConfig, WavLMModel)
from .base import TrunkUpstream, Upstream
from .convert import load_trunk_checkpoint, load_wavlm_checkpoint

_REGISTRY: Dict[str, Callable[..., Upstream]] = {}


def register(name: str):
    def deco(fn):
        _REGISTRY[name] = fn
        return fn
    return deco


def options() -> List[str]:
    return sorted(_REGISTRY)


def load(name: str, **kwargs) -> Upstream:
    """Build a named upstream: ``load(name, dtype=torch.float32, flash=False,
    quantize=False, seed=0, device=None)``. ``device=None`` is the card
    (``"cuda"``); pass ``device="cpu"`` to build on the CPU. The fused int8
    projections of int8 serving (``quantize=True, flash=True``) are opt-in
    keywords, all False by default: ``qkv_fuse`` and ``full_fuse`` on
    HuBERT (K12), ``wavlm_fuse`` on WavLM (K11). The front-end options,
    also False by default: ``int8_conv`` (K13a + K13b; HuBERT with
    ``quantize=True``), ``fused_conv`` (K3 erf + K14) and ``fused_midln``
    (K15). The pos-conv options, also False by default and in every dtype:
    ``fused_posconv`` (K16a) and ``int8_posconv`` (K16b). A keyword that
    cannot take effect raises a ValueError before any weight is made. On
    the Base models (``hubert``, ``hubert_base``, ``wavlm``, ``wavlm_base``,
    ``wavlm_base_plus``): the front-end options raise (the group-norm
    extractor runs no kernel), ``qkv_fuse`` / ``full_fuse`` raise (post-LN
    blocks), ``wavlm_fuse`` works, and the pos-conv options work on the CPU
    but raise for the card, whose kernels take 64 channels a group (768 in
    16 groups is 48). A model bound for the card also raises for
    ``flash=True`` at a head dim other than 64 (every entry has 64; a
    checkpoint may not: XLS-R 1B / 2B have 80 / 120). data2vec's depth-5
    pos-conv stack runs no kernel, so the pos-conv options raise on it;
    ``wavlm_fuse`` raises on WavLM without the gate or the bias.

    ``ckpt``: a local checkpoint (s3prl's converted trunk checkpoints or a
    bare state_dict; Microsoft's WavLM checkpoints for the WavLM and
    UniSpeech-SAT entries), whose configuration replaces the entry's (a
    bare state_dict keeps the entry's). Every check above runs on that
    configuration before the model is allocated. ``download=True`` raises
    NotImplementedError: the port downloads nothing."""
    if name not in _REGISTRY:
        raise KeyError(f"unknown upstream '{name}'; available: {options()}")
    if kwargs.pop("download", False) and kwargs.get("ckpt") is None:
        raise NotImplementedError(
            "download= is not ported (it needs upstream/urls.py and util/download.py, "
            "ROADMAP.md Queue 1 item 11): pass ckpt= with a local checkpoint")
    return _REGISTRY[name](**kwargs)


def _device(device) -> torch.device:
    """The model's device: `device` when given, else the card."""
    if device is not None:
        return torch.device(device)
    if not torch.cuda.is_available():
        raise RuntimeError(
            "no CUDA device: the port builds its models on the card; pass "
            'device="cpu" to build on the CPU')
    return torch.device("cuda")


def _normal_(w: torch.Tensor, fan_in: int, gen: torch.Generator) -> None:
    """LeCun normal (the JAX package's default kernel init), drawn in f32
    and cast, so every dtype rounds the same draw."""
    w.copy_(torch.randn(w.shape, generator=gen) / math.sqrt(fan_in))


@torch.no_grad()
def _init_trunk(model: Wav2Vec2Trunk, gen: torch.Generator) -> Wav2Vec2Trunk:
    """Random weights in module order with flax's initialisers: LeCun-normal
    matrices, zero biases, unit/zero norms, U[0, 1) mask embedding; WavLM's
    bias table normal(0.02) and gate scale ``grep_a`` ones."""
    for m in model.modules():
        if isinstance(m, nn.Conv1d):
            _normal_(m.weight, m.weight[0].numel(), gen)
        elif isinstance(m, nn.Linear):
            _normal_(m.weight, m.in_features, gen)
        elif isinstance(m, SelfAttention):
            _normal_(m.qkv_weight, m.qkv_weight.shape[1], gen)
            m.qkv_bias.zero_()
            if isinstance(m, GatedSelfAttention) and m.gated:
                m.grep_a.fill_(1.0)
        elif isinstance(m, (nn.LayerNorm, nn.GroupNorm)):
            m.weight.fill_(1.0)
            m.bias.zero_()
        elif isinstance(m, nn.Embedding):
            m.weight.copy_(torch.randn(m.weight.shape, generator=gen) * 0.02)
        if isinstance(m, (nn.Conv1d, nn.Linear)) and m.bias is not None:
            m.bias.zero_()
    model.mask_emb.copy_(torch.rand(model.mask_emb.shape, generator=gen))
    return model


def _trunk_upstream(name: str, cfg: Wav2Vec2Config, dtype=torch.float32,
                    flash: bool = False, quantize: bool = False, seed: int = 0,
                    device=None, ckpt=None, **fuse) -> Upstream:
    """A trunk model (WavLM for a `WavLMConfig`) on `device` (the card when
    None): from `ckpt`, whose configuration replaces `cfg` (a bare trunk
    state_dict keeps `cfg`), or with random weights from `seed`. ``fuse``:
    the model's fused int8 projection options (`Wav2Vec2Trunk.fuse_options`),
    front-end and pos-conv options, checked before any weight is made, and
    for the card also against its kernels' limits (`card_refusal`). The
    checkpoint's weights are loaded on the CPU (the int8 codes quantized
    there from its f32 weights by the load hooks) before the move."""
    wavlm = isinstance(cfg, WavLMConfig)
    state_dict = None
    if ckpt is not None:  # the JAX package's _trunk_upstream / _wavlm_upstream
        cfg, state_dict = (load_wavlm_checkpoint(ckpt) if wavlm
                           else load_trunk_checkpoint(ckpt, fallback_cfg=cfg))
    model_cls = WavLMModel if wavlm else Wav2Vec2Trunk
    model = model_cls(cfg, dtype=dtype, use_flash=flash, quantize=quantize, device="meta",
                      **fuse)
    device = _device(device)
    if device.type == "cuda":  # the meta model allocated nothing
        card_refusal(cfg, flash, model.encoder.pos_conv.option)
    model.to_empty(device="cpu")
    if state_dict is None:
        _init_trunk(model, torch.Generator().manual_seed(seed))
        model.build_qcache()
    else:  # the load hooks build the int8 cache and the options' weights
        model.load_state_dict(state_dict, strict=True)
    model.to(device).eval()
    up_cls = Upstream if wavlm else TrunkUpstream
    return up_cls(name=name, model=model, num_layers=cfg.encoder_layers + 1,
                  hidden_size=cfg.encoder_embed_dim, downsample_rate=cfg.downsample_rate)


# the parameter-free baseline front ends (registry.py:77-101): one "layer",
# the frame shift's stride, the reference yaml configs' feature dims
BASELINE_DIMS = {"fbank": 80 * 3, "fbank_no_cmvn": 80, "mfcc": 13 * 3, "spectrogram": 257,
                 "mel": 80, "linear": 201}


def _baseline_entry(config_name: str):
    def factory(device=None, **overrides) -> Upstream:
        model = BaselineFeatures(config_name, device=_device(device), **overrides)
        return Upstream(name=config_name, model=model, num_layers=1,
                        hidden_size=BASELINE_DIMS[config_name],
                        downsample_rate=model.stride)
    return factory


for _name in BASELINE_CONFIGS:
    _REGISTRY[_name] = _baseline_entry(_name)


# wav2vec2 derives its feature lengths with strict conv arithmetic
# (wav2vec2_model.py:2610-2669), HuBERT with its block-folded rule
W2V2_BASE = replace(BASE, feat_pad_rule="conv")
W2V2_LARGE = replace(LARGE, feat_pad_rule="conv")
# data2vec (registry.py:481-508): post-LN on the layer-norm extractor, the
# depth-5 pos-conv stack (k = 95 // 5 = 19), the projection at any width
DATA2VEC_BASE = Wav2Vec2Config(
    extractor_mode="layer_norm", conv_pos=95, pos_conv_depth=5, layer_norm_first=False,
    normalize=True, dropout=0.0, attention_dropout=0.0, dropout_input=0.0,
    post_extract_proj_always=True, feat_pad_rule="conv")
DATA2VEC_LARGE = replace(DATA2VEC_BASE, encoder_layers=24, encoder_embed_dim=1024,
                         encoder_ffn_embed_dim=4096, encoder_attention_heads=16)


@register("wav2vec2")
@register("wav2vec2_base_960")
def wav2vec2_base(**kwargs) -> Upstream:
    return _trunk_upstream("wav2vec2", W2V2_BASE, **kwargs)


@register("wav2vec2_large_ll60k")
@register("wav2vec2_large_lv60_cv_swbd_fsh")
def wav2vec2_large(**kwargs) -> Upstream:
    return _trunk_upstream("wav2vec2_large", W2V2_LARGE, **kwargs)


@register("hubert")
@register("hubert_base")
def hubert_base(**kwargs) -> Upstream:
    return _trunk_upstream("hubert", HUBERT_BASE, **kwargs)


@register("hubert_large_ll60k")
def hubert_large(**kwargs) -> Upstream:
    return _trunk_upstream("hubert_large", HUBERT_LARGE, **kwargs)


@register("data2vec")
@register("data2vec_base_960")
def data2vec_base(**kwargs) -> Upstream:
    return _trunk_upstream("data2vec", DATA2VEC_BASE, **kwargs)


@register("data2vec_large_ll60k")
def data2vec_large(**kwargs) -> Upstream:
    return _trunk_upstream("data2vec_large", DATA2VEC_LARGE, **kwargs)


@register("wavlm")
@register("wavlm_base")
def wavlm_base(**kwargs) -> Upstream:
    return _trunk_upstream("wavlm", WAVLM_BASE, **kwargs)


@register("wavlm_base_plus")
def wavlm_base_plus(**kwargs) -> Upstream:
    return _trunk_upstream("wavlm_base_plus", WAVLM_BASE_PLUS, **kwargs)


@register("wavlm_large")
def wavlm_large(**kwargs) -> Upstream:
    return _trunk_upstream("wavlm_large", WAVLM_LARGE, **kwargs)


# UniSpeech-SAT shares WavLM's gated relative-position architecture
# (registry.py:693-716)
@register("unispeech_sat")
@register("unispeech_sat_base")
def unispeech_sat(**kwargs) -> Upstream:
    return _trunk_upstream("unispeech_sat", WAVLM_BASE, **kwargs)


@register("unispeech_sat_base_plus")
def unispeech_sat_base_plus(**kwargs) -> Upstream:
    return _trunk_upstream("unispeech_sat_base_plus", WAVLM_BASE_PLUS, **kwargs)


@register("unispeech_sat_large")
def unispeech_sat_large(**kwargs) -> Upstream:
    return _trunk_upstream("unispeech_sat_large", WAVLM_LARGE, **kwargs)


# the catalog's aliases (registry.py:1524-1528): without a checkpoint each
# builds its family's default; the published shape comes with ckpt=
for _alias in ("wav2vec2_large_960", "wav2vec2_large_voxpopuli_100k", "xlsr_53",
               "xls_r_300m", "xls_r_1b", "xls_r_2b"):
    _REGISTRY[_alias] = wav2vec2_large
for _alias in ("hubert_base_robust_mgr", "mhubert_base_vp_en_es_fr_it3",
               "contentvec", "contentvec_km100", "contentvec_km500", "ms_hubert"):
    _REGISTRY[_alias] = hubert_base
