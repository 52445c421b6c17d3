"""Named upstream registry (port of s3prl_tpu/upstream/registry.py).

Ported entries: ``hubert_large_ll60k``, in f32, bf16 and int8 W8A8
(``quantize=True``, the serving default). Without a checkpoint (loading one
is a later slice) the weights are random, drawn on the CPU from a
`torch.Generator` seeded with `seed`, so one seed gives the same model on
every device. With ``quantize`` the encoder's projections are quantized
once, on the CPU from their f32 values, before the model moves to `device`
(the JAX package's `_materialize_qcache`, registry.py:117-148).
"""

from __future__ import annotations

import math
from typing import Callable, Dict, List

import torch
import torch.nn as nn

from ..models.hubert import HUBERT_LARGE
from ..models.transformer import SelfAttention
from ..models.wav2vec2 import Wav2Vec2Config, Wav2Vec2Trunk
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
    quantize=False, seed=0, device="cpu")``."""
    if name not in _REGISTRY:
        raise KeyError(f"unknown upstream '{name}'; available: {options()}")
    return _REGISTRY[name](**kwargs)


def _normal_(w: torch.Tensor, fan_in: int, gen: torch.Generator) -> None:
    """LeCun normal (the JAX package's default kernel init), drawn in f32
    and cast, so every dtype rounds the same draw."""
    w.copy_(torch.randn(w.shape, generator=gen) / math.sqrt(fan_in))


@torch.no_grad()
def _init_trunk(model: Wav2Vec2Trunk, gen: torch.Generator) -> Wav2Vec2Trunk:
    """Random weights in module order: LeCun-normal matrices, zero biases,
    unit/zero norms, U[0, 1) mask embedding (flax's initialisers)."""
    for m in model.modules():
        if isinstance(m, nn.Conv1d):
            _normal_(m.weight, m.weight[0].numel(), gen)
        elif isinstance(m, nn.Linear):
            _normal_(m.weight, m.in_features, gen)
        elif isinstance(m, SelfAttention):
            _normal_(m.qkv_weight, m.qkv_weight.shape[1], gen)
            m.qkv_bias.zero_()
        elif isinstance(m, nn.LayerNorm):
            m.weight.fill_(1.0)
            m.bias.zero_()
        if isinstance(m, (nn.Conv1d, nn.Linear)) and m.bias is not None:
            m.bias.zero_()
    model.mask_emb.copy_(torch.rand(model.mask_emb.shape, generator=gen))
    return model


def _trunk_upstream(name: str, cfg: Wav2Vec2Config, dtype=torch.float32,
                    flash: bool = False, quantize: bool = False, seed: int = 0,
                    device="cpu", ckpt=None) -> Upstream:
    if ckpt is not None:
        raise NotImplementedError(
            "ckpt= loading is not ported yet (ROADMAP.md Queue 1 item 6)")
    model = Wav2Vec2Trunk(cfg, dtype=dtype, use_flash=flash, quantize=quantize,
                          device="meta")
    model.to_empty(device="cpu")
    _init_trunk(model, torch.Generator().manual_seed(seed))
    model.build_qcache()
    model.to(device).eval()
    return Upstream(name=name, model=model, num_layers=cfg.encoder_layers + 1,
                    hidden_size=cfg.encoder_embed_dim,
                    downsample_rate=cfg.downsample_rate)


@register("hubert_large_ll60k")
def hubert_large(**kwargs) -> Upstream:
    return _trunk_upstream("hubert_large", HUBERT_LARGE, **kwargs)
