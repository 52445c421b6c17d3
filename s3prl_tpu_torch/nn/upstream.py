"""Packaged model API: SUpstream + Featurizer + UpstreamDownstreamModel
(port of s3prl_tpu/nn/upstream.py; the reference's s3prl/nn/upstream.py:
38-385).

- `SUpstream(name)` loads a hub entry and exposes the padded-batch forward
  ``(wavs [B, T], wav_lens [B]) -> (hs [L, B, T', H], h_lens [B])`` under
  the reference's length rules, with ``.as_list()`` for the reference's
  list-of-tensors shape. Frozen by default: the model in ``eval()`` under
  ``torch.no_grad()``, so the card's kernels serve it.
- `Featurizer` is the trainable softmax weighted sum over layers
  (reference: nn/upstream.py:234-349): zero-initialised weights, softmaxed
  and cast to the states' dtype, then one product over the layer axis, so
  neither it nor its backward makes a tensor of the stack's size (the
  states never require grad; the weights' gradient reads each layer once).
- `UpstreamDownstreamModel` holds the featurizer and a downstream head
  (reference: nn/upstream.py:352-385). The upstream stays outside it, as
  in the JAX package: a probe's ``train()`` never reaches the upstream.
"""

from __future__ import annotations

import math
from typing import List, Optional, Sequence

import torch
import torch.nn as nn

from ..upstream.base import Upstream
from .heads import GRU, LSTM, Conv, Dense

_DTYPES = {"float32": torch.float32, "f32": torch.float32,
           "bfloat16": torch.bfloat16, "bf16": torch.bfloat16}


def _normalize(hs: torch.Tensor) -> torch.Tensor:
    """LayerNorm without affine over the last axis, in hs's dtype:
    (hs - mean) * rsqrt(var + 1e-5), the population variance."""
    mean = hs.mean(dim=-1, keepdim=True)
    var = hs.var(dim=-1, keepdim=True, correction=0)
    return (hs - mean) * torch.rsqrt(var + 1e-5)


class SUpstream:
    """User-facing upstream wrapper (analog of S3PRLUpstream). `extra_conf`
    holds `hub.load`'s keywords; its ``dtype`` may be a name ("bf16",
    "bfloat16", "f32", "float32"), as a YAML config gives it."""

    def __init__(
        self,
        name: str,
        path_or_url: Optional[str] = None,
        refresh: bool = False,
        normalize: bool = False,
        extra_conf: Optional[dict] = None,
        randomize: bool = False,
    ):
        conf = dict(extra_conf or {})
        if isinstance(conf.get("dtype"), str):
            conf["dtype"] = _DTYPES[conf["dtype"]]
        if path_or_url is not None:
            conf["ckpt"] = path_or_url
        if randomize:
            conf.pop("ckpt", None)  # random init = no checkpoint
        from ..upstream.registry import load  # the registry's models import nn.heads

        self.upstream: Upstream = load(name, **conf)
        self.normalize = normalize

    @property
    def num_layers(self) -> int:
        return self.upstream.num_layers

    @property
    def hidden_sizes(self) -> List[int]:
        return self.upstream.hidden_sizes

    @property
    def downsample_rates(self) -> List[int]:
        return self.upstream.downsample_rates

    def __call__(self, wavs, wav_lens, train: bool = False,
                 generator: Optional[torch.Generator] = None):
        """`Upstream.__call__` (train mode's dropouts drawn from `generator`),
        then the optional normalisation."""
        hs, h_lens = self.upstream(wavs, wav_lens, train=train, generator=generator)
        if self.normalize:
            hs = _normalize(hs)
        return hs, h_lens

    def as_list(self, hs: torch.Tensor, h_lens: torch.Tensor):
        """Reference-shaped output: (List[hs[B,T,H]], List[h_lens[B]])."""
        return [hs[i] for i in range(hs.shape[0])], [h_lens] * hs.shape[0]


class Featurizer(nn.Module):
    """Trainable softmax weighted sum over upstream layers (reference:
    s3prl/nn/upstream.py:234-349): passes a single-layer upstream through,
    takes an optional layer subset and pre-norm."""

    def __init__(self, num_layers: int, layer_selections: Optional[Sequence[int]] = None,
                 normalize: bool = False):
        super().__init__()
        self.num_layers = num_layers
        self.layer_selections = (None if layer_selections is None
                                 else tuple(sorted(layer_selections)))
        self.normalize = normalize
        n = num_layers if self.layer_selections is None else len(self.layer_selections)
        self.weights = nn.Parameter(torch.zeros(n)) if num_layers > 1 else None

    def forward(self, hs: torch.Tensor, h_lens: torch.Tensor):
        """hs [L, B, T, H] -> (weighted [B, T, H] in hs's dtype, h_lens)."""
        if hs.shape[0] != self.num_layers:
            raise ValueError(f"hs has {hs.shape[0]} layers, the featurizer {self.num_layers}")
        if self.num_layers == 1:
            return hs[0], h_lens
        if self.layer_selections is not None:
            hs = hs[list(self.layer_selections)]
        if self.normalize:
            hs = _normalize(hs)
        w = torch.softmax(self.weights, dim=0).to(hs.dtype)
        return torch.matmul(w, hs.reshape(hs.shape[0], -1)).view(hs.shape[1:]), h_lens


class UpstreamDownstreamModel(nn.Module):
    """Featurizer + downstream head over a (usually frozen) upstream whose
    forward happens outside this module (upstream_trainable=False in
    nn/upstream.py:352-385 and the SUPERB frozen-probe protocol)."""

    def __init__(self, downstream: nn.Module, num_layers: int,
                 layer_selections: Optional[Sequence[int]] = None,
                 featurizer_normalize: bool = False):
        super().__init__()
        self.featurizer = Featurizer(num_layers, layer_selections, featurizer_normalize)
        self.downstream = downstream

    def forward(self, hs, h_lens, *args, **kwargs):
        h, h_len = self.featurizer(hs, h_lens)
        return self.downstream(h, h_len, *args, **kwargs)


def init_params(module: nn.Module, generator: Optional[torch.Generator] = None) -> nn.Module:
    """flax's initialisation of a probe, drawn from `generator` in module
    order: every `Dense` and `Conv` lecun-normal with a zero bias, every
    `LSTM` and `GRU` as flax's cell (lecun-normal input kernels, an
    orthogonal recurrent kernel a gate, zero biases), every ``nn.LayerNorm``
    and ``nn.BatchNorm1d`` ones and zeros (running statistics 0 and 1),
    every ``nn.Embedding`` as flax's ``nn.Embed`` (a normal of standard
    deviation 1 / sqrt(features), drawn on the CPU), every featurizer's
    weights zero."""
    for m in module.modules():
        if isinstance(m, (Dense, Conv, LSTM, GRU)):
            m.reset_parameters(generator)
        elif isinstance(m, (nn.LayerNorm, nn.BatchNorm1d)):
            m.reset_parameters()
        elif isinstance(m, nn.Embedding):
            draw = torch.randn(m.weight.shape, generator=generator) / math.sqrt(m.embedding_dim)
            with torch.no_grad():
                m.weight.copy_(draw)
        elif isinstance(m, Featurizer) and m.weights is not None:
            nn.init.zeros_(m.weights)
    return module
