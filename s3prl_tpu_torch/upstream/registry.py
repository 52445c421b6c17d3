"""Named upstream registry (port of s3prl_tpu/upstream/registry.py).

Ported entries, with the JAX package's names and configurations
(s3prl_tpu/upstream/registry.py:232-240, :290-308): ``hubert_large_ll60k``
and ``wavlm_large`` (pre-LN, layer-norm extractor), ``hubert`` /
``hubert_base`` and ``wavlm`` / ``wavlm_base`` / ``wavlm_base_plus`` (the
Base models: post-LN, group-norm extractor), each in f32, bf16 and int8
W8A8 (``quantize=True``, the serving default), the int8 path with its
opt-in fused projections (``qkv_fuse``, ``full_fuse``; ``wavlm_fuse``), the
front-end options ``int8_conv`` (HuBERT int8), ``fused_conv`` and
``fused_midln``, and the pos-conv options ``fused_posconv`` and
``int8_posconv``, each where it can take effect (`load`). A model is built
on the card (``torch.device("cuda")``) unless ``device=`` says otherwise;
without CUDA and without ``device=`` loading raises rather than building
on the CPU. Without a checkpoint (loading one is a later slice)
the weights are random, drawn on the CPU from a `torch.Generator` seeded
with `seed`, so one seed gives the same model on every device. With
``quantize`` the encoder's projections are quantized once, on the CPU from
their f32 values, before the model moves to its device (the JAX package's
`_materialize_qcache`, registry.py:117-148).
"""

from __future__ import annotations

import math
from typing import Callable, Dict, List

import torch
import torch.nn as nn

from ..models.hubert import HUBERT_BASE, HUBERT_LARGE
from ..models.transformer import SelfAttention
from ..models.wav2vec2 import Wav2Vec2Config, Wav2Vec2Trunk, card_refusal
from ..models.wavlm import (WAVLM_BASE, WAVLM_BASE_PLUS, WAVLM_LARGE, GatedSelfAttention,
                            WavLMConfig, WavLMModel)
from .base import Upstream

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
    ``flash=True`` at a head dim other than 64 (every entry has 64)."""
    if name not in _REGISTRY:
        raise KeyError(f"unknown upstream '{name}'; available: {options()}")
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
            if isinstance(m, GatedSelfAttention):
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
    """A trunk model (WavLM for a `WavLMConfig`) with random weights from
    `seed`, on `device` (the card when None). ``fuse``: the model's fused
    int8 projection options (`Wav2Vec2Trunk.fuse_options`), front-end and
    pos-conv options, checked before any weight is made, and for the card
    also against its kernels' limits (`card_refusal`)."""
    model_cls = WavLMModel if isinstance(cfg, WavLMConfig) else Wav2Vec2Trunk
    model = model_cls(cfg, dtype=dtype, use_flash=flash, quantize=quantize, device="meta",
                      **fuse)
    if ckpt is not None:
        raise NotImplementedError(
            "ckpt= loading is not ported yet (ROADMAP.md Queue 1 item 4)")
    device = _device(device)
    if device.type == "cuda":  # the meta model allocated nothing
        card_refusal(cfg, flash, model.encoder.pos_conv.option)
    model.to_empty(device="cpu")
    _init_trunk(model, torch.Generator().manual_seed(seed))
    model.build_qcache()
    model.to(device).eval()
    return Upstream(name=name, model=model, num_layers=cfg.encoder_layers + 1,
                    hidden_size=cfg.encoder_embed_dim,
                    downsample_rate=cfg.downsample_rate)


@register("hubert")
@register("hubert_base")
def hubert_base(**kwargs) -> Upstream:
    return _trunk_upstream("hubert", HUBERT_BASE, **kwargs)


@register("hubert_large_ll60k")
def hubert_large(**kwargs) -> Upstream:
    return _trunk_upstream("hubert_large", HUBERT_LARGE, **kwargs)


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
