"""Transformer encoder with convolutional positional embedding (port of
s3prl_tpu/models/transformer.py): pre-LN blocks (the *-Large models) and
post-LN blocks (HuBERT-Base, fairseq's layer_norm_first=False).

Per-layer hidden states come back as the stack of every layer's input plus
the last one's output, [L+1, B, T, C] (transformer.py:743-789): pre-LN
runs the encoder LayerNorm after the layers, on that output; post-LN runs
it before them, on the pos-conv's sum, so the first hidden state is
normalised and the last is the last layer's output (:735-736, :782-783).
With ``layer_weights`` [L+1] (SUPERB's weighted sum, :686-787) the stack is
never made: one accumulator in the model dtype takes w[i] * (input of
layer i), then w[L] * output (after the final LN when pre-LN), and the
encoder returns [1, B, T, C].

The pos-conv is one grouped conv (`ConvPositionalEmbedding`) or, with
``pos_conv_depth`` > 1, data2vec's stack of conv + affine-free LN + GELU
blocks (`ConvPositionalStack`, transformer.py:49-68), which runs no kernel.

Routing of a pre-LN `EncoderLayer` (transformer.py:389-563). A layer runs
"quant serving" when it is built with ``quantize``, is in eval mode and the
fused kernels can serve its input (CUDA, see `_fused_block_available`); it
runs the bf16 kernels when it is a bf16 ``use_flash`` layer without
``quantize``, in eval mode, with eps 1e-5, on such an input. T is compared
with the kernels module's MAX_BLOCK_T and MAX_KERNEL_T at call time:
- the whole block, quant serving with ``use_flash``, eps 1e-5 and the
  layer's ``full_fuse`` option, at every T: K12 `fused_int8_linear` (LN +
  QKV), K7 (K8 beyond MAX_KERNEL_T), K12 (out-proj + residual), K2
  (transformer.py:393-405, :355-379);
- attention, quant serving with ``use_flash``: T <= MAX_BLOCK_T -> K1
  `fused_attention_block`; beyond it the f32 LN rounded to bf16, the QKV
  projection through int8_matmul (with the ``qkv_fuse`` option K12, whose
  f32 LN is not rounded, in their place, :471-484), then K6
  `fused_qkv_attention_outproj` (transformer.py:481-492; K6 hands its
  attention to K8 beyond MAX_KERNEL_T);
- attention, bf16 kernels: T <= MAX_BLOCK_T -> K4 `fused_attention_block_bf16`;
  beyond it the module path below (:525-526);
- attention otherwise, the module path: LN, then `SelfAttention`, whose
  ``use_flash`` branch runs K7 `fused_qkv_attention` (K8 beyond
  MAX_KERNEL_T) between the projections (:182-185);
- FFN: quant serving -> K2 `fused_int8_ffn` with the LN and the residual
  folded in (eps 1e-5; other eps: module LN, then K2 bare); the bf16
  kernels -> K5 `fused_bf16_ffn` at every T; otherwise fc1 -> erf GELU ->
  fc2, through int8_matmul under ``quantize``. K2 runs tanh GELU, the
  module path erf, as in the JAX package.
A layer whose FFN activation is ReLU or swish (``activation``, fairseq's
``activation_fn``) never runs quant serving nor the bf16 FFN kernel, whose
FFNs compute GELU: its FFN is the module path with its activation, its
attention the module path (through int8_matmul under ``quantize``, K7 with
``use_flash``), or K4 for a pre-LN bf16 ``use_flash`` layer, whose gate in
the JAX package does not read the activation (transformer.py:389-392,
:494-502, :540-546, :580-586).
Routing of a post-LN `EncoderLayer` (transformer.py:564-668), the same
gates, with each LN after its residual sum:
- attention, quant serving or the bf16 kernels with ``use_flash``, eps
  1e-5 and T <= MAX_BLOCK_T: K1 `fused_attention_block` or K4
  `fused_attention_block_bf16` with ``postnorm`` (K1 quantizes the raw
  residual rows, with no LN before the QKV);
- attention, quant serving with ``use_flash`` beyond MAX_BLOCK_T: the QKV
  through int8_matmul on raw x in the model dtype, K6 (K8 beyond
  MAX_KERNEL_T), then the stock f32 LN cast back (:612-638);
- attention otherwise: LN(x + SelfAttention(x)), the module path above;
- FFN, quant serving or the bf16 kernels with ``ffn_dim % 128 == 0``, eps
  1e-5: K2 or K5 with ``postnorm`` at every T; otherwise LN(x + ffn(x)),
  ffn being K2 bare under quant serving and the module path otherwise.
``qkv_fuse`` and ``full_fuse`` exist only in the pre-LN branch: a post-LN
layer refuses them.
On the card, K7 takes bf16 qkv: an f32 ``use_flash`` layer raises there.
WavLM's layers (`models/wavlm.py`) subclass `EncoderLayer` and pass their
gated relative-position bias to `SelfAttention` (``rel_bias``), whose
``use_flash`` branch then runs K9 `gated_bias_attention` (K10 beyond
MAX_KERNEL_T) in place of K7.

Train mode (``train()``) takes the module paths, with flax's dropouts
drawn from the forward's ``generator`` (transformer.py:416-417, :737): the
encoder's input after the pos-conv (and the post-LN encoder LN), each
residual branch's output (``dropout``) and the FFN's activation
(``activation_dropout``); none on the attention probabilities, which the
JAX package never drops (``SelfAttention.dropout`` is unused, :142). The
attention between the projections stays K7 / K9 under ``use_flash``.

With ``layer_type="conformer"`` (wav2vec2-Conformer, transformer.py:
719-745, :790-936) the encoder has no pos-conv and its layers are
`ConformerLayer`s: half-step swish FFNs, ESPnet attention with
Transformer-XL relative positions (a sinusoid table per T, cached on the
device) or rotary embeddings, the conv module (pointwise GLU, depthwise
SAME conv, BatchNorm on its running statistics, swish, pointwise) and a
final LN, all on stock ops: the JAX package runs them with no kernel and
ignores ``use_flash`` / ``quantize`` there. Eval mode only (its BatchNorm
would update statistics in train mode; `upstream.base.train_refusal`).

Matrix weights live in the model dtype, biases and norms in f32, as the JAX
package casts them at use. With ``quantize`` the encoder layers keep their
matrix weights in f32 (the JAX package's param dtype) and hold the int8
codes and scales quantized once from them (`EncoderLayer.build_qcache`, the
port's ``qcache``) as non-persistent buffers, so `state_dict()` keeps the
fairseq keys. f32 matmuls on the card need
``torch.backends.cuda.matmul.allow_tf32 = False`` (PyTorch's default) to
match the JAX package's full-f32 products.
"""

from __future__ import annotations

import functools

import numpy as np
import torch
import torch.nn as nn
import torch.nn.functional as F

from ..kernels import flash_attention as fa  # MAX_BLOCK_T / MAX_KERNEL_T read at call time
from ..kernels import posconv as pc  # MAX_POSCONV_T read at call time
from ..kernels.ffn import fused_bf16_ffn, fused_int8_ffn, fused_int8_linear
from ..kernels.flash_attention import (fused_attention_block, fused_attention_block_bf16,
                                       fused_qkv_attention, fused_qkv_attention_outproj,
                                       gated_bias_attention)
from ..nn.heads import dropout
from ..ops.attention import NEG_INF, attention_bthd
from ..ops.quant import as_quantized_cols, int8_matmul


# the FFN activations of EncoderLayer (transformer.py:296-303)
ACTIVATIONS = {"gelu": F.gelu, "relu": F.relu, "swish": F.silu}


def _fused_block_available(x: torch.Tensor) -> bool:
    """The fused serving kernels run for CUDA tensors (the JAX package's
    `_fused_block_available` checks for a TPU). Tests patch this to send CPU
    tensors through the kernel wrappers, whose plain versions then run."""
    return x.is_cuda


def _layer_norm(x: torch.Tensor, norm: nn.LayerNorm) -> torch.Tensor:
    """f32 LayerNorm cast back to x.dtype (nn.LayerNorm(dtype=f32) then astype)."""
    y = F.layer_norm(x.float(), norm.normalized_shape, norm.weight, norm.bias, norm.eps)
    return y.to(x.dtype)


def on_card(device) -> bool:
    """Whether `device` names a CUDA device (a model built there is checked
    against the card kernels' limits at load)."""
    return device is not None and torch.device(device).type == "cuda"


def _linear(x: torch.Tensor, layer: nn.Linear) -> torch.Tensor:
    return F.linear(x, layer.weight, layer.bias.to(x.dtype))


class _QCache:
    """Non-persistent int8 buffers ``<name>_q8`` / ``<name>_scale`` beside
    the weights they quantize; `qpair(name)` returns the (codes, scales)
    pair and raises while the cache is not built."""

    def _register_qcache(self, *names: str) -> None:
        for name in names:
            self.register_buffer(f"{name}_q8", None, persistent=False)
            self.register_buffer(f"{name}_scale", None, persistent=False)

    def _store_qcache(self, name: str, w: torch.Tensor) -> None:
        codes, scales = as_quantized_cols(w.float())
        setattr(self, f"{name}_q8", codes)
        setattr(self, f"{name}_scale", scales)

    def qpair(self, name: str):
        codes = getattr(self, f"{name}_q8")
        if codes is None:
            raise RuntimeError(
                f"the int8 weights of {name} are not built: call build_qcache() "
                "after the weights are in place")
        return codes, getattr(self, f"{name}_scale")


class ConvPositionalEmbedding(nn.Sequential):
    """Grouped conv positional embedding, depth 1 (transformer.py:32): conv
    (k=128, 16 groups, pad k//2) -> drop the last frame (even k) -> GELU.
    The conv sits at index 0 as in fairseq's Sequential(conv, SamePad,
    GELU), so the keys read ``pos_conv.0.{weight,bias}``; checkpoints with
    weight norm are folded into the plain weight before loading.

    ``option`` (the JAX package's pos-conv switch, transformer.py:72-117):
    None, the stock conv; "fused", K16a `pos_conv_gelu` from the tap-major
    weight in `dtype`; "int8", K16b `pos_conv_gelu_q8` from int8 codes
    quantized from the weight, which then stays f32. The option's weights are
    non-persistent buffers built by `build_qcache` (after every
    `load_state_dict`). The kernels run in eval mode for T <= MAX_POSCONV_T
    (read at call time); train() and longer sequences take the stock conv.
    An option whose kernel cannot take this configuration raises a
    ValueError before anything is allocated: the JAX gate (k even and a
    multiple of the tap chunk) everywhere, and on a CUDA device the card
    kernel's limits too, its tap limit and its GROUP_WIDTH channels a group
    (`card_refusal`; the plain version takes any k and any width)."""

    # option -> (keyword, tap chunk, the card kernel's largest k)
    OPTIONS = {"fused": ("fused_posconv", pc.TC, pc.MAX_TAPS),
               "int8": ("int8_posconv", pc.TC_Q8, pc.MAX_TAPS_Q8)}

    def __init__(self, features: int, kernel_size: int = 128, groups: int = 16,
                 dtype: torch.dtype = torch.float32, option: str | None = None, device=None):
        if option is not None:
            name, tc, _ = self.OPTIONS[option]
            if kernel_size % 2 or kernel_size % tc:
                raise ValueError(f"{name} cannot take effect: its kernel needs an even conv_pos "
                                 f"that is a multiple of {tc}, got {kernel_size}")
            if on_card(device):
                self.card_refusal(features, kernel_size, groups, option)
        super().__init__(nn.Conv1d(features, features, kernel_size,
                                   padding=kernel_size // 2, groups=groups,
                                   device=device))
        self.option = option  # a plain attribute, not state
        if option != "int8":  # K16b quantizes from the f32 weight
            self[0].weight.data = self[0].weight.data.to(dtype)
        for name in {"fused": ("gemm_weight",), "int8": ("w_q8", "w_scale")}.get(option, ()):
            self.register_buffer(name, None, persistent=False)
        if option is not None:
            self.register_load_state_dict_post_hook(lambda m, _: m.build_qcache())

    @classmethod
    def card_refusal(cls, features: int, kernel_size: int, groups: int, option: str) -> None:
        """Raises the ValueError of an option whose card kernel cannot take
        this pos-conv: k over its tap limit, or other than GROUP_WIDTH
        channels a group (`kernels/posconv.py`)."""
        name, _, max_taps = cls.OPTIONS[option]
        if kernel_size > max_taps:
            raise ValueError(f"{name} cannot take effect on the card: its kernel takes "
                             f"conv_pos up to {max_taps}, got {kernel_size}")
        if features % groups or features // groups != pc.GROUP_WIDTH:
            raise ValueError(f"{name} cannot take effect on the card: its kernel takes "
                             f"{pc.GROUP_WIDTH} channels a group, got {features} channels in "
                             f"{groups} groups")

    @torch.no_grad()
    def build_qcache(self) -> None:
        """Builds the option's weights from the conv weight: K16a's tap-major
        GEMM weight (``"fused"``), K16b's int8 codes and scales from the f32
        weight (``"int8"``); a no-op without an option."""
        conv = self[0]
        if self.option == "fused":
            self.gemm_weight = pc.posconv_gemm_weight(conv.weight, conv.groups)
        elif self.option == "int8":
            self.w_q8, self.w_scale = pc.quantize_posconv_weight(conv.weight, conv.groups)

    def _cached(self, name: str) -> torch.Tensor:
        value = getattr(self, name)
        if value is None:
            raise RuntimeError(f"the pos-conv option's weights ({name}) are not built: call "
                               "build_qcache() after the weights are in place")
        return value

    def forward(self, x: torch.Tensor) -> torch.Tensor:  # [B, T, C]
        conv = self[0]
        if self.option is not None and not self.training and x.shape[1] <= pc.MAX_POSCONV_T:
            if self.option == "fused":
                return pc.pos_conv_gelu(x, self._cached("gemm_weight"), conv.bias, conv.groups)
            return pc.pos_conv_gelu_q8(x, (self._cached("w_q8"), self._cached("w_scale")),
                                       conv.bias, conv.groups)
        # the weight cast to x's dtype at use, as nn.Conv(dtype=...) casts its param
        y = F.conv1d(x.transpose(1, 2), conv.weight.to(x.dtype), conv.bias.to(x.dtype),
                     padding=conv.padding, groups=conv.groups)
        if conv.kernel_size[0] % 2 == 0:
            y = y[..., :-1]
        return F.gelu(y).transpose(1, 2)


class ConvPositionalStack(nn.Sequential):
    """data2vec's pos-conv stack (transformer.py:49-68, fairseq's
    make_conv_block): ``depth`` blocks of a grouped conv with k = max(3,
    conv_pos // depth) and pad k // 2 in the model dtype (its f32 weight and
    bias cast at use), the trailing frame dropped when k is even, an
    affine-free f32 LayerNorm (eps 1e-5) cast to the model dtype, then erf
    GELU. Each block is Sequential(conv, ...) as in fairseq, so the keys read
    ``pos_conv.{i}.0.{weight,bias}``. Stock ops only: the pos-conv options'
    kernels take the one-conv form, so ``option`` is None here and the
    encoder refuses them (`refuse_option`)."""

    option = None  # no kernel option: the trunk refuses fused_posconv / int8_posconv

    def __init__(self, features: int, kernel_size: int, groups: int, depth: int, device=None):
        k = max(3, kernel_size // depth)
        super().__init__(*(nn.Sequential(nn.Conv1d(features, features, k, padding=k // 2,
                                                   groups=groups, device=device))
                           for _ in range(depth)))

    @staticmethod
    def refuse_option(depth: int, option: str | None) -> None:
        """Raises the ValueError of a pos-conv option on a depth > 1 stack."""
        if option is not None and depth > 1:
            name = ConvPositionalEmbedding.OPTIONS[option][0]
            raise ValueError(f"{name} cannot take effect: the depth-{depth} pos-conv stack runs "
                             "no kernel (its kernels take the one-conv pos-conv)")

    def build_qcache(self) -> None:
        """No option weights to build."""

    def forward(self, x: torch.Tensor) -> torch.Tensor:  # [B, T, C]
        for block in self:
            conv = block[0]
            y = F.conv1d(x.transpose(1, 2), conv.weight.to(x.dtype), conv.bias.to(x.dtype),
                         padding=conv.padding, groups=conv.groups).transpose(1, 2)
            if conv.kernel_size[0] % 2 == 0:
                y = y[:, :-1]
            y = F.layer_norm(y.float(), (y.shape[-1],), eps=1e-5).to(x.dtype)
            x = F.gelu(y)
        return x


class SelfAttention(_QCache, nn.Module):
    """Multi-head self-attention with one fused QKV projection.

    The fused weight `qkv_weight` [3C, C] (q, k, v rows stacked, nn.Linear
    layout) is what the kernels read; `state_dict()` and `load_state_dict()`
    speak fairseq's ``{q,k,v}_proj.{weight,bias}`` keys. With ``quantize``
    the projections run int8 W8A8 from the cached ``qkv`` and ``out_proj``
    codes; with ``use_flash`` the attention between them is K7
    `fused_qkv_attention` (forward-only on the card)."""

    def __init__(self, embed_dim: int, num_heads: int, quantize: bool = False,
                 use_flash: bool = False, device=None):
        super().__init__()
        self.num_heads = num_heads
        self.quantize = quantize
        self.use_flash = use_flash
        self.qkv_weight = nn.Parameter(torch.empty(3 * embed_dim, embed_dim, device=device))
        self.qkv_bias = nn.Parameter(torch.empty(3 * embed_dim, device=device))
        self.out_proj = nn.Linear(embed_dim, embed_dim, device=device)
        self._register_qcache("qkv", "out_proj")

    def _save_to_state_dict(self, destination, prefix, keep_vars):
        super()._save_to_state_dict(destination, prefix, keep_vars)
        for kind, fused in (("weight", self.qkv_weight), ("bias", self.qkv_bias)):
            del destination[f"{prefix}qkv_{kind}"]
            for name, part in zip("qkv", fused.chunk(3)):
                destination[f"{prefix}{name}_proj.{kind}"] = part if keep_vars else part.detach()

    def _load_from_state_dict(self, state_dict, prefix, local_metadata, strict,
                              missing_keys, unexpected_keys, error_msgs):
        for kind in ("weight", "bias"):
            keys = [f"{prefix}{n}_proj.{kind}" for n in "qkv"]
            if all(k in state_dict for k in keys):
                state_dict[f"{prefix}qkv_{kind}"] = torch.cat(
                    [state_dict.pop(k) for k in keys])
        super()._load_from_state_dict(state_dict, prefix, local_metadata, strict,
                                      missing_keys, unexpected_keys, error_msgs)

    def forward(self, x: torch.Tensor, pad_mask: torch.Tensor, rel_bias=None,
                attn_bias=None) -> torch.Tensor:
        """transformer.py:156-200: x [B, T, C] in the model dtype, pad_mask
        [B, T] True on padded keys; `rel_bias` = (pos_bias [H, T, T], gate
        [B, H, T]) is WavLM's gated relative-position bias, `attn_bias`
        ([1, H, T, T]) WavLM's bias without the gate. With ``use_flash`` and
        no `attn_bias` the attention is K9 `gated_bias_attention` (K10
        beyond MAX_KERNEL_T) on the split heads, given the bias as it comes
        (f32, or the bf16 model's padded bf16 buffer) and the gate in f32,
        or K7 without a bias; otherwise plain ops (attention_bthd), the bias
        (gate * pos_bias formed in the model dtype, or `attn_bias`) added to
        the f32 scores before the mask."""
        B, T, C = x.shape
        H = self.num_heads
        Dh = C // H
        if self.quantize:
            qkv = int8_matmul(x, self.qpair("qkv"), self.qkv_bias)
        else:
            qkv = F.linear(x, self.qkv_weight, self.qkv_bias.to(x.dtype))
        if self.use_flash and attn_bias is None:
            kv_lens = (~pad_mask).sum(-1, dtype=torch.int32)
            if rel_bias is None:
                out = fused_qkv_attention(qkv, kv_lens, H)
            else:
                pos_bias, gate = rel_bias
                out = gated_bias_attention(*fa._split_heads(qkv, H), pos_bias, gate.float(),
                                           kv_lens)
                out = out.transpose(1, 2).reshape(B, T, C)
        else:
            q, k, v = qkv.view(B, T, 3, H, Dh).unbind(2)
            q = q * Dh ** -0.5
            scores = torch.einsum("bthd,bshd->bhts", q.float(), k.float())
            if rel_bias is not None:
                pos_bias, gate = rel_bias
                attn_bias = gate[..., None] * pos_bias[None]
            if attn_bias is not None:
                scores = scores + attn_bias.float()
            scores = scores.masked_fill(pad_mask[:, None, None, :], -1e9)
            probs = scores.softmax(-1).to(v.dtype)
            out = torch.einsum("bhts,bshd->bthd", probs, v).reshape(B, T, C)
        if self.quantize:
            return int8_matmul(out, self.qpair("out_proj"), self.out_proj.bias)
        return _linear(out, self.out_proj)


class EncoderLayer(_QCache, nn.Module):
    """Transformer block (wav2vec2_model.py:3214): pre-LN with
    ``layer_norm_first`` (x + attn(LN(x)), then x + ffn(LN(x))), post-LN
    without it (LN(x + attn(x)), then LN(x + ffn(x))). The routing of both
    is in the module docstring."""

    attention = SelfAttention  # the self-attention module (WavLM's adds the gate)

    def __init__(self, embed_dim: int, ffn_dim: int, num_heads: int,
                 dtype: torch.dtype = torch.float32, use_flash: bool = False,
                 quantize: bool = False, layer_norm_eps: float = 1e-5, device=None,
                 qkv_fuse: bool = False, full_fuse: bool = False,
                 layer_norm_first: bool = True, attention_kwargs: dict | None = None,
                 dropout: float = 0.0, activation_dropout: float = 0.0,
                 activation: str = "gelu"):
        """``attention_kwargs``: further keywords of the `attention` class;
        ``dropout`` / ``activation_dropout``: the train-mode rates of the
        residual branches and of the FFN's activation; ``activation``: the
        FFN's, "gelu" (erf), "relu" or "swish" (transformer.py:290-303)."""
        self.refuse_options(layer_norm_first, qkv_fuse, full_fuse)
        if activation not in ACTIVATIONS:
            raise ValueError(f"activation {activation!r}: one of {sorted(ACTIVATIONS)}")
        super().__init__()
        self.dtype = dtype
        self.activation = activation  # a plain attribute, not state
        # the train-mode rates: plain attributes, not state
        self.dropout, self.activation_dropout = dropout, activation_dropout
        self.layer_norm_first = layer_norm_first
        self.use_flash = use_flash
        self.quantize = quantize
        self.num_heads = num_heads
        # the fused int8 projections (K12) of quant serving; plain attributes,
        # not state: the JAX package's QKV-fuse and full-fuse switches
        self.qkv_fuse = qkv_fuse
        self.full_fuse = full_fuse
        self.self_attn = self.attention(embed_dim, num_heads, quantize, use_flash,
                                        device=device, **(attention_kwargs or {}))
        self.self_attn_layer_norm = nn.LayerNorm(embed_dim, eps=layer_norm_eps, device=device)
        self.fc1 = nn.Linear(embed_dim, ffn_dim, device=device)
        self.fc2 = nn.Linear(ffn_dim, embed_dim, device=device)
        self.final_layer_norm = nn.LayerNorm(embed_dim, eps=layer_norm_eps, device=device)
        self._register_qcache("fc1", "fc2")
        if quantize:  # f32 weights, quantized once into the cache
            self.register_load_state_dict_post_hook(lambda m, _: m.build_qcache())
        else:
            for p in (self.self_attn.qkv_weight, self.self_attn.out_proj.weight,
                      self.fc1.weight, self.fc2.weight):
                p.data = p.data.to(dtype)

    @staticmethod
    def refuse_options(layer_norm_first: bool, qkv_fuse: bool, full_fuse: bool) -> None:
        """``qkv_fuse`` and ``full_fuse`` fuse the pre-LN block's LN + QKV
        (transformer.py:393-405, :471-480): a post-LN block raises a
        ValueError for them."""
        on = [name for name, value in (("qkv_fuse", qkv_fuse), ("full_fuse", full_fuse)) if value]
        if on and not layer_norm_first:
            raise ValueError(f"{on[0]} cannot take effect: it fuses the pre-LN block's LN + QKV, "
                             "and this model's blocks are post-LN")

    @torch.no_grad()
    def build_qcache(self) -> None:
        """Quantizes the four projection weights once, from their f32
        values, into the int8 cache (the JAX package's ``qcache``
        collection, upstream/registry.py:117-148). Runs after every
        `load_state_dict`; call it after setting the weights otherwise."""
        attn = self.self_attn
        attn._store_qcache("qkv", attn.qkv_weight)
        attn._store_qcache("out_proj", attn.out_proj.weight)
        self._store_qcache("fc1", self.fc1.weight)
        self._store_qcache("fc2", self.fc2.weight)

    def _drop(self, x: torch.Tensor, generator) -> torch.Tensor:
        """The residual branch's dropout (train mode only)."""
        return dropout(x, self.dropout, self.training, generator)

    def _ffn(self, h: torch.Tensor, generator=None) -> torch.Tensor:
        """The FFN's module path on the normalised h: fc1 -> the activation
        (erf GELU, ReLU or swish) -> (train mode) activation dropout -> fc2,
        through int8_matmul under ``quantize``."""
        act = ACTIVATIONS[self.activation]
        if self.quantize:
            h = act(int8_matmul(h, self.qpair("fc1"), self.fc1.bias))
            h = dropout(h, self.activation_dropout, self.training, generator)
            return int8_matmul(h, self.qpair("fc2"), self.fc2.bias)
        h = dropout(act(_linear(h, self.fc1)), self.activation_dropout, self.training, generator)
        return _linear(h, self.fc2)

    def _fully_fused(self, x: torch.Tensor, kv_lens: torch.Tensor) -> torch.Tensor:
        """``full_fuse``: the whole pre-LN block as K12(LN, QKV) -> K7 (K8
        beyond MAX_KERNEL_T) -> K12(out-proj, residual x) -> K2(LN, residual)
        (transformer.py:355-379)."""
        attn, ln1, ln2 = self.self_attn, self.self_attn_layer_norm, self.final_layer_norm
        qkv = fused_int8_linear(x, attn.qpair("qkv"), attn.qkv_bias, ln=(ln1.weight, ln1.bias))
        a = fused_qkv_attention(qkv, kv_lens, self.num_heads)
        x = fused_int8_linear(a, attn.qpair("out_proj"), attn.out_proj.bias, residual=x)
        return fused_int8_ffn(x, self.qpair("fc1"), self.fc1.bias, self.qpair("fc2"),
                              self.fc2.bias, ln=(ln2.weight, ln2.bias), residual=True)

    def forward(self, x: torch.Tensor, kv_lens: torch.Tensor,
                pad_mask: torch.Tensor, generator=None) -> torch.Tensor:
        """x [B, T, C] in the model dtype; kv_lens [B] int32 valid frames;
        pad_mask [B, T] True on padded frames; `generator`: train mode's
        dropouts."""
        attn, ln1, ln2 = self.self_attn, self.self_attn_layer_norm, self.final_layer_norm
        # the kernels' FFNs compute GELU: quant serving and the bf16 FFN (and
        # the post-LN bf16 block) need it, as the JAX gates do
        # (transformer.py:389-392, :540-546, :580-586); the pre-LN bf16
        # attention block (K4) does not read it (:496-502)
        gelu = self.activation == "gelu"
        quant_serving = (self.quantize and not self.training and gelu
                         and _fused_block_available(x))
        fused = (
            not self.training and not self.quantize and self.dtype == torch.bfloat16
            and self.use_flash and ln1.eps == 1e-5 and _fused_block_available(x)
        )
        if not self.layer_norm_first:
            return self._post_ln(x, kv_lens, pad_mask, quant_serving, fused and gelu, generator)
        if quant_serving and self.full_fuse and self.use_flash and ln1.eps == 1e-5:
            return self._fully_fused(x, kv_lens)
        block_t = x.shape[1] <= fa.MAX_BLOCK_T
        if quant_serving and self.use_flash and block_t:
            x = fused_attention_block(
                x, attn.qpair("qkv"), attn.qkv_bias, (ln1.weight, ln1.bias),
                attn.qpair("out_proj"), attn.out_proj.bias, kv_lens, self.num_heads)
        elif quant_serving and self.use_flash:
            if self.qkv_fuse:  # LN (f32, not rounded) + QKV in K12 (transformer.py:471-480)
                qkv = fused_int8_linear(x, attn.qpair("qkv"), attn.qkv_bias,
                                        ln=(ln1.weight, ln1.bias))
            else:
                qkv = int8_matmul(_layer_norm(x, ln1), attn.qpair("qkv"), attn.qkv_bias,
                                  out_dtype=self.dtype)
            x = fused_qkv_attention_outproj(qkv, x, attn.qpair("out_proj"),
                                            attn.out_proj.bias, kv_lens, self.num_heads)
        elif fused and block_t:
            x = fused_attention_block_bf16(
                x, attn.qkv_weight, attn.qkv_bias, (ln1.weight, ln1.bias),
                attn.out_proj.weight, attn.out_proj.bias, kv_lens, self.num_heads)
        else:
            x = x + self._drop(attn(_layer_norm(x, ln1), pad_mask), generator)
        if quant_serving and ln2.eps == 1e-5:
            return fused_int8_ffn(x, self.qpair("fc1"), self.fc1.bias, self.qpair("fc2"),
                                  self.fc2.bias, ln=(ln2.weight, ln2.bias), residual=True)
        if fused and gelu and self.fc1.out_features % 128 == 0:
            return fused_bf16_ffn(x, self.fc1.weight, self.fc1.bias, self.fc2.weight,
                                  self.fc2.bias, ln=(ln2.weight, ln2.bias), residual=True)
        h = _layer_norm(x, ln2)
        if quant_serving:  # eps != 1e-5: K2 without its LN (transformer.py:422-428)
            return x + fused_int8_ffn(h, self.qpair("fc1"), self.fc1.bias, self.qpair("fc2"),
                                      self.fc2.bias)
        return x + self._drop(self._ffn(h, generator), generator)

    def _post_ln(self, x: torch.Tensor, kv_lens: torch.Tensor, pad_mask: torch.Tensor,
                 quant_serving: bool, fused: bool, generator=None) -> torch.Tensor:
        """The post-LN block (transformer.py:564-668): x = LN1(x + attn(x)),
        then x = LN2(x + ffn(x)), each LN in f32 cast back to x.dtype."""
        attn, ln1, ln2 = self.self_attn, self.self_attn_layer_norm, self.final_layer_norm
        if ((quant_serving or fused) and self.use_flash and ln1.eps == 1e-5
                and x.shape[1] <= fa.MAX_BLOCK_T):
            if quant_serving:
                x = fused_attention_block(
                    x, attn.qpair("qkv"), attn.qkv_bias, (ln1.weight, ln1.bias),
                    attn.qpair("out_proj"), attn.out_proj.bias, kv_lens, self.num_heads,
                    postnorm=True)
            else:
                x = fused_attention_block_bf16(
                    x, attn.qkv_weight, attn.qkv_bias, (ln1.weight, ln1.bias),
                    attn.out_proj.weight, attn.out_proj.bias, kv_lens, self.num_heads,
                    postnorm=True)
        elif quant_serving and self.use_flash:  # the QKV on raw x (transformer.py:612-638)
            qkv = int8_matmul(x, attn.qpair("qkv"), attn.qkv_bias, out_dtype=self.dtype)
            x = _layer_norm(fused_qkv_attention_outproj(qkv, x, attn.qpair("out_proj"),
                                                        attn.out_proj.bias, kv_lens,
                                                        self.num_heads), ln1)
        else:
            x = _layer_norm(x + self._drop(attn(x, pad_mask), generator), ln1)
        if ((quant_serving or (fused and self.fc1.out_features % 128 == 0))
                and ln2.eps == 1e-5):
            if quant_serving:
                return fused_int8_ffn(x, self.qpair("fc1"), self.fc1.bias, self.qpair("fc2"),
                                      self.fc2.bias, ln=(ln2.weight, ln2.bias), residual=True,
                                      postnorm=True)
            return fused_bf16_ffn(x, self.fc1.weight, self.fc1.bias, self.fc2.weight,
                                  self.fc2.bias, ln=(ln2.weight, ln2.bias), residual=True,
                                  postnorm=True)
        if quant_serving:  # K2 bare (transformer.py:422-428)
            h = fused_int8_ffn(x, self.qpair("fc1"), self.fc1.bias, self.qpair("fc2"),
                               self.fc2.bias)
        else:
            h = self._drop(self._ffn(x, generator), generator)
        return _layer_norm(x + h, ln2)


@functools.lru_cache(maxsize=16)
def relative_positional_table(T: int, d_model: int, device=None) -> torch.Tensor:
    """The Transformer-XL sinusoid table [2T-1, d_model] (transformer.py:
    790-805, rows from relative position T-1 down to -(T-1)), built in
    float64 with numpy, cast to f32 on `device` (the CPU by default) and
    cached per (T, device)."""
    position = np.arange(T, dtype=np.float64)[:, None]
    div = np.exp(np.arange(0, d_model, 2, dtype=np.float64) * -(np.log(10000.0) / d_model))
    pos, neg = np.zeros((T, d_model)), np.zeros((T, d_model))
    pos[:, 0::2], pos[:, 1::2] = np.sin(position * div), np.cos(position * div)
    neg[:, 0::2], neg[:, 1::2] = np.sin(-position * div), np.cos(-position * div)
    table = np.concatenate([pos[::-1], neg[1:]], axis=0).astype(np.float32)
    with torch.inference_mode(False):  # a cached tensor that autograd may read later
        return torch.from_numpy(table).to(device)


@functools.lru_cache(maxsize=16)
def _rotary_tables(T: int, head_dim: int, device) -> torch.Tensor:
    """cos and sin [2, T, head_dim] of the rotary embedding (transformer.py:
    837-842), float64 cast to f32 on `device`, cached per (T, device)."""
    inv_freq = 1.0 / (10000 ** (np.arange(0, head_dim, 2) / head_dim))
    t = np.arange(T)[:, None] * inv_freq[None, :]
    emb = np.concatenate([t, t], axis=-1)
    with torch.inference_mode(False):  # a cached tensor that autograd may read later
        return torch.from_numpy(np.stack([np.cos(emb), np.sin(emb)]).astype(np.float32)).to(device)


def _rel_shift(x: torch.Tensor) -> torch.Tensor:
    """[B, H, T, 2T-1] -> [B, H, T, T] (transformer.py:808-813): the
    pad-reshape-slice that puts score (t, s) at relative position t - s."""
    B, H, T, P = x.shape
    xp = F.pad(x, (1, 0)).reshape(B, H, P + 1, T)
    return xp[:, :, 1:].reshape(B, H, T, P)[..., :(P + 1) // 2]


class EspnetSelfAttention(nn.Module):
    """ESPnet multi-head attention (transformer.py:815-871) with separate
    ``linear_q/k/v/out`` projections and ``pos_enc_type``:
    - ``"rel_pos"``: ``linear_pos`` (no bias) over the sinusoid table, the
      f32 ``pos_bias_u`` / ``pos_bias_v`` [H, Dh] cast to q's dtype, the
      scores ``ac + rel_shift(bd)`` in f32 scaled after the sum, -1e9 on
      padded keys, the probabilities cast to v's dtype;
    - ``"rope"``: the layer input rotated per head (cos / sin in x's dtype)
      before the q / k projections, v projected from the unrotated input;
    - ``"abs"`` and ``"rope"`` then run `ops.attention.attention_bthd` on
      q * Dh ** -0.5."""

    def __init__(self, embed_dim: int, num_heads: int, pos_enc_type: str = "rel_pos",
                 device=None):
        super().__init__()
        if pos_enc_type not in ("abs", "rel_pos", "rope"):
            raise ValueError(f"pos_enc_type {pos_enc_type!r}: 'abs', 'rel_pos' or 'rope'")
        self.num_heads, self.pos_enc_type = num_heads, pos_enc_type
        for name in ("linear_q", "linear_k", "linear_v", "linear_out"):
            setattr(self, name, nn.Linear(embed_dim, embed_dim, device=device))
        if pos_enc_type == "rel_pos":
            self.linear_pos = nn.Linear(embed_dim, embed_dim, bias=False, device=device)
            head_dim = embed_dim // num_heads
            self.pos_bias_u = nn.Parameter(torch.empty(num_heads, head_dim, device=device))
            self.pos_bias_v = nn.Parameter(torch.empty(num_heads, head_dim, device=device))

    def forward(self, x: torch.Tensor, pad_mask: torch.Tensor,
                pos_emb: torch.Tensor | None = None) -> torch.Tensor:
        """x [B, T, C] in the model dtype, pad_mask [B, T] True on padded
        keys, `pos_emb` the f32 table [2T-1, C] (``"rel_pos"``)."""
        B, T, C = x.shape
        H = self.num_heads
        Dh = C // H
        x_in = x
        if self.pos_enc_type == "rope":
            cos, sin = _rotary_tables(T, Dh, x.device).to(x.dtype)[:, None, :, None, :]
            xh = x.view(B, T, H, Dh)
            rot = torch.cat([-xh[..., Dh // 2:], xh[..., :Dh // 2]], -1)
            x_in = (xh * cos + rot * sin).reshape(B, T, C)
        q = _linear(x_in, self.linear_q).view(B, T, H, Dh)
        k = _linear(x_in, self.linear_k).view(B, T, H, Dh)
        v = _linear(x, self.linear_v).view(B, T, H, Dh)
        scale = Dh ** -0.5
        if self.pos_enc_type == "rel_pos":
            p = F.linear(pos_emb.to(x.dtype), self.linear_pos.weight).view(-1, H, Dh)
            q_u = q + self.pos_bias_u.to(q.dtype)
            q_v = q + self.pos_bias_v.to(q.dtype)
            ac = torch.einsum("bthd,bshd->bhts", q_u.float(), k.float())
            bd = torch.einsum("bthd,phd->bhtp", q_v.float(), p.float())
            scores = (ac + _rel_shift(bd)) * scale
            scores = scores.masked_fill(pad_mask[:, None, None, :], NEG_INF)
            probs = scores.softmax(-1).to(v.dtype)
            out = torch.einsum("bhts,bshd->bthd", probs, v)
        else:
            out = attention_bthd(q * scale, k, v, pad_mask)
        return _linear(out.reshape(B, T, C), self.linear_out)


class FeedForwardModule(nn.Module):
    """The Conformer's half-step FFN (fairseq's FeedForwardModule names):
    f32 LN cast back -> ``w_1`` -> swish -> ``w_2``."""

    def __init__(self, embed_dim: int, ffn_dim: int, device=None):
        super().__init__()
        self.layer_norm = nn.LayerNorm(embed_dim, device=device)
        self.w_1 = nn.Linear(embed_dim, ffn_dim, device=device)
        self.w_2 = nn.Linear(ffn_dim, embed_dim, device=device)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return _linear(F.silu(_linear(_layer_norm(x, self.layer_norm), self.w_1)), self.w_2)


class ConvolutionModule(nn.Module):
    """The Conformer's conv module (transformer.py:917-931, fairseq's
    ConvolutionModule names): f32 LN cast back -> ``pointwise_conv1`` (no
    bias) -> GLU -> ``depthwise_conv`` (k taps, SAME padding, no bias; the
    padded frames are not masked again, so they bleed into the valid ones
    as in the reference) -> ``batch_norm`` on its running statistics (flax's
    form, whose f32 output the swish keeps) -> swish -> ``pointwise_conv2``
    (no bias) in the model dtype."""

    def __init__(self, embed_dim: int, kernel_size: int, device=None):
        super().__init__()
        self.layer_norm = nn.LayerNorm(embed_dim, device=device)
        self.pointwise_conv1 = nn.Conv1d(embed_dim, 2 * embed_dim, 1, bias=False, device=device)
        self.depthwise_conv = nn.Conv1d(embed_dim, embed_dim, kernel_size, groups=embed_dim,
                                        bias=False, device=device)
        self.batch_norm = nn.BatchNorm1d(embed_dim, device=device)
        self.pointwise_conv2 = nn.Conv1d(embed_dim, embed_dim, 1, bias=False, device=device)

    def forward(self, x: torch.Tensor) -> torch.Tensor:  # [B, T, C]
        dtype = x.dtype
        h = F.linear(_layer_norm(x, self.layer_norm), self.pointwise_conv1.weight[:, :, 0])
        a, b = h.chunk(2, dim=-1)
        h = a * torch.sigmoid(b)
        k = self.depthwise_conv.kernel_size[0]
        h = F.conv1d(F.pad(h.transpose(1, 2), ((k - 1) // 2, k // 2)),
                     self.depthwise_conv.weight, groups=self.depthwise_conv.groups)
        bn = self.batch_norm
        scale = torch.rsqrt(bn.running_var + bn.eps) * bn.weight
        h = (h.float() - bn.running_mean[:, None]) * scale[:, None] + bn.bias[:, None]
        h = F.silu(h).transpose(1, 2).to(dtype)
        return F.linear(h, self.pointwise_conv2.weight[:, :, 0])


class ConformerLayer(nn.Module):
    """Macaron Conformer block (transformer.py:874-936): x + FFN1 / 2, x +
    attention(LN(x)), x + conv module, x + FFN2 / 2, then the final LN.
    Matrix and conv weights in the model dtype, biases, norms, the position
    biases and BatchNorm in f32."""

    quantize = False  # its projections stay in the model dtype (JAX ignores quantize here)

    def __init__(self, embed_dim: int, ffn_dim: int, num_heads: int,
                 dtype: torch.dtype = torch.float32, pos_enc_type: str = "rel_pos",
                 depthwise_kernel: int = 31, device=None):
        super().__init__()
        self.ffn1 = FeedForwardModule(embed_dim, ffn_dim, device)
        self.self_attn_layer_norm = nn.LayerNorm(embed_dim, device=device)
        self.self_attn = EspnetSelfAttention(embed_dim, num_heads, pos_enc_type, device)
        self.conv_module = ConvolutionModule(embed_dim, depthwise_kernel, device)
        self.ffn2 = FeedForwardModule(embed_dim, ffn_dim, device)
        self.final_layer_norm = nn.LayerNorm(embed_dim, device=device)
        for m in self.modules():
            if isinstance(m, (nn.Linear, nn.Conv1d)):
                m.weight.data = m.weight.data.to(dtype)

    def forward(self, x: torch.Tensor, kv_lens: torch.Tensor, pad_mask: torch.Tensor,
                pos_emb: torch.Tensor | None = None, generator=None) -> torch.Tensor:
        """x [B, T, C] in the model dtype; `pos_emb` the relative-position
        table (``"rel_pos"``); `kv_lens` and `generator` unused (the
        encoder's layer signature)."""
        x = 0.5 * self.ffn1(x) + x
        x = x + self.self_attn(_layer_norm(x, self.self_attn_layer_norm), pad_mask, pos_emb)
        x = x + self.conv_module(x)
        x = 0.5 * self.ffn2(x) + x
        return _layer_norm(x, self.final_layer_norm)


class TransformerEncoder(nn.Module):
    """Encoder stack returning [L+1, B, T, C]: the input of every layer,
    then the last one's output, after the encoder LayerNorm when pre-LN
    (transformer.py:671; post-LN runs that LN before the layers); with
    ``layer_weights`` their weighted sum [1, B, T, C] (`forward`)."""

    def __init__(self, embed_dim: int = 1024, ffn_dim: int = 4096, num_layers: int = 24,
                 num_heads: int = 16, layer_norm_first: bool = True, conv_pos: int = 128,
                 conv_pos_groups: int = 16, dtype: torch.dtype = torch.float32,
                 use_flash: bool = False, quantize: bool = False, device=None,
                 posconv: str | None = None, pos_conv_depth: int = 1,
                 dropout: float = 0.0, activation_dropout: float = 0.0,
                 use_pos_conv: bool = True, layer_type: str = "transformer",
                 pos_enc_type: str = "rel_pos", depthwise_kernel: int = 31,
                 activation: str = "gelu", **fuse):
        """``posconv``: the pos-conv option (`ConvPositionalEmbedding`;
        refused on a ``pos_conv_depth`` > 1 stack); ``dropout`` /
        ``activation_dropout``: the train-mode rates (the encoder input's and
        the layers'); ``use_pos_conv`` False: no pos-conv (MR-HuBERT's inner
        encoders, transformer.py:715); ``layer_type`` "conformer":
        `ConformerLayer`s with ``pos_enc_type`` and ``depthwise_kernel``, no
        pos-conv; ``activation``: the transformer layers' FFN activation;
        ``fuse``: the layers' ``qkv_fuse`` / ``full_fuse`` options."""
        ConvPositionalStack.refuse_option(pos_conv_depth, posconv)
        conformer = layer_type == "conformer"
        super().__init__()
        self.layer_norm_first = layer_norm_first
        self.dropout = dropout
        self.pos_enc_type = pos_enc_type if conformer else None
        if conformer or not use_pos_conv:
            self.pos_conv = None
        elif pos_conv_depth > 1:
            self.pos_conv = ConvPositionalStack(embed_dim, conv_pos, conv_pos_groups,
                                                pos_conv_depth, device=device)
        else:
            self.pos_conv = ConvPositionalEmbedding(embed_dim, conv_pos, conv_pos_groups, dtype,
                                                    posconv, device=device)
        self.layers = nn.ModuleList([
            ConformerLayer(embed_dim, ffn_dim, num_heads, dtype, pos_enc_type, depthwise_kernel,
                           device=device) if conformer else
            EncoderLayer(embed_dim, ffn_dim, num_heads, dtype, use_flash, quantize,
                         device=device, layer_norm_first=layer_norm_first, dropout=dropout,
                         activation_dropout=activation_dropout, activation=activation, **fuse)
            for _ in range(num_layers)
        ])
        self.layer_norm = nn.LayerNorm(embed_dim, device=device)

    def _layer_args(self, T: int, device) -> tuple:
        """Inputs every layer takes after (x, kv_lens, pad_mask), built once
        per forward: the Conformer's relative-position table (``"rel_pos"``),
        else none (WavLM's encoder adds its shared bias)."""
        if self.pos_enc_type == "rel_pos":
            return (relative_positional_table(T, self.layer_norm.normalized_shape[0], device),)
        return ()

    def forward(self, x: torch.Tensor, feat_lens: torch.Tensor,
                layer_weights: torch.Tensor | None = None, generator=None) -> torch.Tensor:
        """x [B, T, C] in the model dtype, feat_lens [B] valid frames ->
        hidden states [L+1, B, T, C]; with ``layer_weights`` [L+1] (a tensor
        on x's device) their weighted sum [1, B, T, C] (transformer.py:
        743-787): acc += w[i] * h in the model dtype, the weight cast to it,
        the product rounded before the sum as XLA rounds JAX's
        ``acc + w.astype(h.dtype) * h``, layer by layer, with no
        [L+1, B, T, C] stack and no host round trip. `generator`: train
        mode's dropouts."""
        B, T, C = x.shape
        pad_mask = torch.arange(T, device=x.device)[None, :] >= feat_lens[:, None]
        kv_lens = torch.clamp(feat_lens, max=T).to(torch.int32)
        x = x.masked_fill(pad_mask[..., None], 0.0)
        if self.pos_conv is not None:
            x = x + self.pos_conv(x)
        if not self.layer_norm_first:  # transformer.py:735-736
            x = _layer_norm(x, self.layer_norm)
        x = dropout(x, self.dropout, self.training, generator)  # transformer.py:737
        shared = self._layer_args(T, x.device)
        L = len(self.layers)
        if layer_weights is None:
            hidden = x.new_empty(L + 1, B, T, C)
        else:
            if tuple(layer_weights.shape) != (L + 1,):
                raise ValueError(f"layer_weights: shape {tuple(layer_weights.shape)}, "
                                 f"expected ({L + 1},)")
            w = layer_weights.to(x.dtype)
            acc = torch.zeros_like(x)
        for i, layer in enumerate(self.layers):
            if layer_weights is None:
                hidden[i] = x
            else:
                acc += w[i] * x
            x = layer(x, kv_lens, pad_mask, *shared, generator=generator)
        if self.layer_norm_first:
            x = _layer_norm(x, self.layer_norm)
        if layer_weights is not None:
            acc += w[L] * x
            return acc[None]
        hidden[-1] = x
        return hidden
