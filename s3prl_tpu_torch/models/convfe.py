"""Strided conv waveform feature extractor (port of
s3prl_tpu/models/convfe.py:180), on [B, T, C] activations (the JAX
package's layout), in its two modes:
- ``"layer_norm"`` (the *-Large front end): every layer an unpadded strided
  Conv1d -> LayerNorm over channels (f32) -> GELU;
- ``"default"`` (HuBERT-Base, WavLM-Base): layer 0 Conv1d -> per-channel
  GroupNorm over all T' frames of each utterance, padded ones included
  (f32, cast to the model dtype) -> GELU, the other layers Conv1d -> GELU
  (convfe.py:296-345). The group norm's variance is E[x^2] - E[x]^2
  clamped at 0, as flax's GroupNorm computes it. No kernel runs here:
  every layer is stock `F.conv1d` (+ the conv bias in the model dtype, when
  ``conv_bias``) and stock elementwise ops, as the JAX package leaves them
  to XLA.
GELU is exact, except in int8 serving (``quantize``), which runs the tanh
approximation (convfe.py:270-289, :344). Routing of the layer-norm mode
(convfe.py:199-345), in eval mode with k0 == 2 * s0 and no conv bias (the
JAX `fuse0`):
- default: layer 0 through K3 `conv0_ln_gelu`, the mid layers stock
  `F.conv1d` -> f32 LN cast to the model dtype -> GELU, as the JAX package
  leaves them to XLA;
- ``int8_conv`` (the JAX int8 conv chain; needs ``quantize``): K13a
  `conv0_ln_gelu_q8`, then K13b `fused_int8_conv_ln_gelu` on every mid
  layer, int8 rows between layers and the model dtype out of the last;
- ``fused_conv`` (the JAX fused mid convs): K3, then K14 `fused_conv_ln_gelu` on
  every mid layer, erf GELU throughout, also under ``quantize``;
- ``fused_midln`` (the JAX Pallas mid LN): the default path with K15 `ln_gelu`
  after each stock mid conv (tanh under int8 serving, erf otherwise).
The first two need every mid layer to be a stride-2 conv with k 2 or 3.
Every kernel is forward-only: in train() mode every layer, layer 0
included, takes the stock path (the JAX `train=True`, :201-204), and
gradients reach every weight.

With ``int8_conv`` the mid convs keep f32 weights (the JAX param dtype) and
hold K13b's per-tap int8 codes, quantized once from them; with
``fused_conv`` they hold K14's tap-major GEMM weight. Both are built by
`build_qcache`, after every `load_state_dict`, as non-persistent buffers.

On the card, f32 convolutions would run in TF32 unless
``torch.backends.cudnn.allow_tf32`` is False; the f32 path assumes the
caller has turned it off (``chip_smoke.py`` does), as the JAX package runs
them in full f32.
"""

from __future__ import annotations

from typing import Sequence, Tuple

import torch
import torch.nn as nn
import torch.nn.functional as F

from ..kernels.conv_frontend import (MID_TAPS, conv0_ln_gelu, conv0_ln_gelu_q8,
                                     conv_gemm_weight, fused_conv_ln_gelu,
                                     fused_int8_conv_ln_gelu, quantize_conv_taps)
from ..kernels.ln_gelu import ln_gelu
from ..ops.masking import lengths_after_conv1d

# (dim, kernel, stride) stack shared by wav2vec2/HuBERT: total stride 320
DEFAULT_CONV_LAYERS: Tuple[Tuple[int, int, int], ...] = (
    (512, 10, 5),
    (512, 3, 2),
    (512, 3, 2),
    (512, 3, 2),
    (512, 3, 2),
    (512, 2, 2),
    (512, 2, 2),
)


def conv_output_lengths(wav_lens: torch.Tensor, conv_layers=DEFAULT_CONV_LAYERS) -> torch.Tensor:
    """Valid frames after the unpadded strided conv stack (convfe.py:38-42):
    0 for an utterance shorter than the first layer's receptive field."""
    lens = wav_lens
    for _, k, s in conv_layers:
        lens = lengths_after_conv1d(lens, k, s)
    return lens


def total_stride(conv_layers=DEFAULT_CONV_LAYERS) -> int:
    out = 1
    for _, _, s in conv_layers:
        out *= s
    return out


def group_norm_f32(y: torch.Tensor, norm: nn.GroupNorm, stats=None) -> torch.Tensor:
    """Per-channel norm of y [B, T, C] over its T frames, in f32: flax's
    GroupNorm with one channel a group (convfe.py:339-343), whose variance
    is max(0, E[x^2] - E[x]^2) (``use_fast_variance``) and whose scale
    multiplies rsqrt(var + eps) before the centred input does. `stats`
    (time-sharded extraction, `parallel.mesh.TimeShard.extract`) maps the
    f32 frames to the (mean, var) [B, 1, C] of the whole utterance."""
    x = y.float()
    if stats is not None:
        mean, var = stats(x)
    else:
        mean = x.mean(1, keepdim=True)
        var = (x.square().mean(1, keepdim=True) - mean.square()).clamp_min(0.0)
    return (x - mean) * (torch.rsqrt(var + norm.eps) * norm.weight) + norm.bias


class ConvLayer(nn.Sequential):
    """Conv1d -> norm -> GELU. The module indices follow fairseq's
    Sequential(Conv1d, Dropout, norm, GELU), so the keys read ``0.weight``
    (and ``0.bias`` with ``bias``) and, by `norm`:
    - ``"layer"``: Sequential(TransposeLast, Fp32LayerNorm, TransposeLast),
      ``2.1.{weight,bias}``;
    - ``"group"`` (layer 0 of the default extractor): Fp32GroupNorm with a
      group a channel, ``2.{weight,bias}``;
    - None (the default extractor's other layers): no norm."""

    def __init__(self, c_in: int, c_out: int, k: int, stride: int, norm: str | None = "layer",
                 bias: bool = False, device=None):
        mods = [nn.Conv1d(c_in, c_out, k, stride, bias=bias, device=device), nn.Identity()]
        if norm == "layer":
            mods.append(nn.Sequential(nn.Identity(), nn.LayerNorm(c_out, device=device)))
        elif norm == "group":
            mods.append(nn.GroupNorm(c_out, c_out, device=device))
        super().__init__(*mods)
        self.norm_kind = norm

    @property
    def conv(self) -> nn.Conv1d:
        return self[0]

    @property
    def norm(self) -> nn.Module | None:
        """The LayerNorm or the GroupNorm; None without a norm."""
        if self.norm_kind is None:
            return None
        return self[2][1] if self.norm_kind == "layer" else self[2]

    def conv_out(self, x: torch.Tensor) -> torch.Tensor:
        """The stock conv: x [B, T, C_in] -> [B, T', C_out] in x.dtype (the
        weight cast to it, as nn.Conv(dtype=...) casts its f32 param; the
        bias, if any, cast and added after the product, as nn.Conv adds it)."""
        conv = self.conv
        y = F.conv1d(x.transpose(1, 2), conv.weight.to(x.dtype), stride=conv.stride)
        y = y.transpose(1, 2)
        return y if conv.bias is None else y + conv.bias.to(x.dtype)

    def forward(self, x: torch.Tensor, gelu_mode: str = "erf", stats=None) -> torch.Tensor:
        """x [B, T, C_in] -> [B, T', C_out]; the f32 norm is cast to x.dtype
        before the GELU (``approximate`` "none" for erf, "tanh"); `stats`:
        the group norm's statistics hook (`group_norm_f32`)."""
        y = self.conv_out(x)
        if self.norm_kind == "layer":
            y = F.layer_norm(y.float(), (y.shape[-1],), self.norm.weight, self.norm.bias,
                             eps=1e-5).to(x.dtype)
        elif self.norm_kind == "group":
            y = group_norm_f32(y, self.norm, stats).to(x.dtype)
        return F.gelu(y, approximate="tanh" if gelu_mode == "tanh" else "none")


def _cached(layer: ConvLayer, name: str) -> torch.Tensor:
    value = getattr(layer, name)
    if value is None:
        raise RuntimeError(
            f"the front-end option's weights ({name}) are not built: call build_qcache() "
            "after the weights are in place")
    return value


class ConvFeatureExtractor(nn.Module):
    """wavs [B, T] -> features [B, T', C] (valid convs, total stride 320).

    Matrix weights live in `dtype` (the mid convs in f32 with
    ``int8_conv``), conv biases and norms in f32. ``mode`` "layer_norm" or
    "default" (the module docstring). The options ``int8_conv``,
    ``fused_conv`` and ``fused_midln`` (module docstring) are plain
    attributes, not state; one that cannot take effect raises a ValueError
    before any weight is made: the chains need the bias-free layer-norm
    extractor, ``fused_midln`` the layer-norm mode (convfe.py:201-216,
    :322-337)."""

    def __init__(self, conv_layers: Sequence[Tuple[int, int, int]] = DEFAULT_CONV_LAYERS,
                 mode: str = "layer_norm", conv_bias: bool = False,
                 dtype: torch.dtype = torch.float32, quantize: bool = False,
                 device=None, int8_conv: bool = False, fused_conv: bool = False,
                 fused_midln: bool = False):
        super().__init__()
        if mode not in ("layer_norm", "default"):
            raise ValueError(f"extractor mode {mode!r}: 'layer_norm' or 'default'")
        (_, k0, s0), *mid = conv_layers
        # layer 0 through K3 / K13a in eval mode (convfe.py:201-204)
        self.fuse0 = mode == "layer_norm" and not conv_bias and k0 == 2 * s0
        chain = [name for name, on in (("int8_conv", int8_conv), ("fused_conv", fused_conv)) if on]
        if chain and not (self.fuse0 and all(k in MID_TAPS and s == 2 for _, k, s in mid)):
            raise ValueError(f"{chain[0]} cannot take effect: its chain needs the layer-norm "
                             "extractor without conv bias, k0 == 2 * s0 and every mid layer a "
                             f"stride-2 conv with k in {MID_TAPS} (got mode {mode!r}, "
                             f"conv_bias={conv_bias})")
        if fused_midln and mode != "layer_norm":
            raise ValueError(f"fused_midln cannot take effect: its kernel is the mid layers' "
                             f"LN + GELU of the layer-norm extractor (got mode {mode!r})")
        if int8_conv and not quantize:
            raise ValueError("int8_conv is the int8 conv chain of int8 serving: it needs the "
                             "extractor's quantize (quantize=True on HuBERT; WavLM's extractor "
                             "takes no quantize)")
        if int8_conv and fused_conv:
            raise ValueError("int8_conv and fused_conv: the int8 chain takes precedence, so "
                             "fused_conv could not take effect")
        if fused_midln and chain:
            raise ValueError(f"fused_midln and {chain[0]}: the chain replaces the mid layers, "
                             "so fused_midln could not take effect")
        self.dtype = dtype
        self.quantize = quantize
        self.int8_conv, self.fused_conv, self.fused_midln = int8_conv, fused_conv, fused_midln
        layers, c_in = [], 1
        for i, (dim, k, stride) in enumerate(conv_layers):
            norm = "layer" if mode == "layer_norm" else "group" if i == 0 else None
            layers.append(ConvLayer(c_in, dim, k, stride, norm, conv_bias, device=device))
            c_in = dim
        self.conv_layers = nn.ModuleList(layers)
        for i, layer in enumerate(self.conv_layers):
            if not (int8_conv and i):  # K13b quantizes the mid convs from f32
                layer.conv.weight.data = layer.conv.weight.data.to(dtype)
            for name in (("taps_q8", "taps_scale") if int8_conv and i else
                         ("gemm_weight",) if fused_conv and i else ()):
                layer.register_buffer(name, None, persistent=False)
        if chain:
            self.register_load_state_dict_post_hook(lambda m, _: m.build_qcache())

    @torch.no_grad()
    def build_qcache(self) -> None:
        """Builds the chain option's weights from the mid convs' weights:
        K13b's per-tap int8 codes and scales from the f32 weights
        (``int8_conv``), K14's tap-major GEMM weights (``fused_conv``); a
        no-op otherwise. Runs after every `load_state_dict`; call it after
        setting the weights otherwise."""
        for layer in self.conv_layers[1:]:
            if self.int8_conv:
                layer.taps_q8, layer.taps_scale = quantize_conv_taps(layer.conv.weight)
            elif self.fused_conv:
                layer.gemm_weight = conv_gemm_weight(layer.conv.weight)

    def forward(self, wavs: torch.Tensor, group_stats=None) -> torch.Tensor:
        """wavs [B, T] -> [B, T', C]; `group_stats`: the group-norm layer 0's
        statistics hook (`group_norm_f32`; time-sharded extraction)."""
        first, *rest = self.conv_layers
        s0, k0 = first.conv.stride[0], first.conv.kernel_size[0]
        fuse0 = self.fuse0 and not self.training  # the kernels are forward-only
        ln0 = (first.norm.weight, first.norm.bias) if fuse0 else None
        if fuse0 and self.int8_conv:  # convfe.py:239-269
            xq, xs = conv0_ln_gelu_q8(wavs.to(self.dtype), first.conv.weight, *ln0,
                                      stride=s0, k=k0)
            for i, layer in enumerate(rest):
                xq, xs = fused_int8_conv_ln_gelu(
                    xq, xs, (_cached(layer, "taps_q8"), _cached(layer, "taps_scale")),
                    layer.norm.weight, layer.norm.bias, emit_q8=i < len(rest) - 1,
                    out_dtype=self.dtype)
            return xq
        if fuse0 and self.fused_conv:  # convfe.py:217-238: erf GELU, also under quantize
            x = conv0_ln_gelu(wavs.to(self.dtype), first.conv.weight, *ln0, stride=s0, k=k0)
            for layer in rest:
                x = fused_conv_ln_gelu(x, _cached(layer, "gemm_weight"), layer.norm.weight,
                                       layer.norm.bias)
            return x
        # int8 serving runs tanh GELU (serving_tanh, convfe.py:275)
        gelu_mode = "tanh" if self.quantize and not self.training else "erf"
        if fuse0:  # layer 0 through the fused kernel, as convfe.py:276-289 does in extraction
            x = conv0_ln_gelu(wavs.to(self.dtype), first.conv.weight, *ln0, stride=s0, k=k0,
                              gelu_mode=gelu_mode)
        else:  # the stock layer 0 (convfe.py:296-300), then its norm and GELU
            x, rest = wavs[..., None].to(self.dtype), self.conv_layers
        midln = self.fused_midln and not self.training  # convfe.py:322-337
        for layer in rest:
            if midln:
                x = ln_gelu(layer.conv_out(x).contiguous(), layer.norm.weight, layer.norm.bias,
                            gelu_mode)
            else:
                x = layer(x, gelu_mode, group_stats if layer.norm_kind == "group" else None)
        return x
