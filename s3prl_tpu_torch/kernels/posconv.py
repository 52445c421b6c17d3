"""The grouped conv positional embedding + GELU: ports of the Pallas kernels
of s3prl_tpu/kernels/posconv.py.

The wav2vec2-style positional embedding is a grouped conv1d (k = 128, 16
groups, same padding, the trailing frame dropped) followed by erf GELU.

- K16a `pos_conv_gelu` (:159, pallas_call :182): the weights cast to x's
  dtype, f32 sums, + bias in f32, GELU, one cast;
- K16b `pos_conv_gelu_q8` (:104, pallas_call :137): x quantized with one
  symmetric scale per (utterance, group) over all T frames (the zero rows of
  the TPU's padded shift stack do not move its absmax), the weights per
  (group, out channel) from their f32 values, exact int32 sums, then
  f32(acc) * f32(xs * ws) + bias, GELU, one cast to x's dtype.

Both run on `csrc/posconv.cu`: a block owns a run of output frames of one
(utterance, group) (256 for K16a, 512 for K16b), keeps their input window
in shared memory and reads every tap's im2col rows from it. K16b first
finds its activation scales (one absmax pass over x); its conv kernel then
quantizes the window as it loads it, so the codes never reach device
memory. The weights are tap-major per group, [G, C/G, k C/G] in nn.Linear
layout (`posconv_gemm_weight`; `quantize_posconv_weight` for K16b's codes),
built once at load. The model routes here only in eval mode and for T <=
MAX_POSCONV_T, read at call time (the JAX package's gate,
s3prl_tpu/models/transformer.py:76-86); the CUDA kernels themselves have
no bound on T.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

from ..ops.quant import quantize_rows
from ._build import launch
from ._common import on_cpu, refuse_grad, require, stream_of

TC = 16  # K16a's taps per chunk on the TPU: the model's gate needs k % TC == 0
TC_Q8 = 32  # K16b's
MAX_POSCONV_T = 2048  # the model routes longer sequences to the stock conv
GROUP_WIDTH = 64  # the CUDA kernel's channels per group (C 1024, 16 groups)
# the kernels' shared-memory windows hold 256 + k - 1 rows of bf16 (K16a) or
# 512 + k - 1 rows of int8 codes (K16b) beside their weight rings
MAX_TAPS = 512
MAX_TAPS_Q8 = 1024


def posconv_gemm_weight(weight: torch.Tensor, groups: int) -> torch.Tensor:
    """nn.Conv1d weight [C, C/G, k] -> the tap-major GEMM weight [G, C/G, k
    C/G] in the weight's dtype: row n of group g holds weight[g C/G + n, c,
    j] at column j C/G + c (the transpose of each group's `_tap_major_weights`,
    posconv.py:96-100)."""
    C, cg, k = weight.shape
    return weight.reshape(groups, cg, cg, k).permute(0, 1, 3, 2).reshape(
        groups, cg, k * cg).contiguous()


def _conv_weight(w: torch.Tensor, groups: int) -> torch.Tensor:
    """The nn.Conv1d weight [C, C/G, k] of a tap-major GEMM weight (the
    inverse of `posconv_gemm_weight`)."""
    G, cg, kc = w.shape
    return w.reshape(G, cg, kc // cg, cg).permute(0, 1, 3, 2).reshape(G * cg, cg, kc // cg)


def _gemm_weight(weight: torch.Tensor, C: int, groups: int) -> torch.Tensor:
    """K16a's weight argument as the GEMM weight: an nn.Conv1d weight [C,
    C/G, k] is rearranged here, a GEMM weight [G, C/G, k C/G] passes (with C
    = G the two are the same array)."""
    return posconv_gemm_weight(weight, groups) if weight.shape[0] == C else weight


def quantize_posconv_weight(weight: torch.Tensor, groups: int):
    """nn.Conv1d weight [C, C/G, k] -> K16b's (codes [G, C/G, k C/G] int8,
    scales [G, C/G] f32): each group's tap-major weight quantized per output
    channel from its f32 values (posconv.py:129-132)."""
    codes, scales = quantize_rows(posconv_gemm_weight(weight.float(), groups))
    return codes, scales[..., 0]


def _q8_weight(weight, groups: int):
    """K16b's (codes, scales) from an nn.Conv1d weight (quantized here from
    f32) or the load-time pair."""
    if isinstance(weight, (tuple, list)):
        return tuple(weight)
    return quantize_posconv_weight(weight, groups)


def quantize_posconv_input(x: torch.Tensor, groups: int):
    """K16b's activation codes (posconv.py:121-126): x [B, T, C] -> (codes
    [B, T, C] int8, scales [B, G] f32) with xs = max(absmax of the (b, g)
    slice over all T frames, 1e-8) / 127 (a true division) and codes
    clip(round(x / xs), -127, 127), half to even."""
    B, T, C = x.shape
    xg = x.float().reshape(B, T, groups, C // groups)
    amax = xg.abs().amax(dim=(1, 3))
    xs = torch.clamp(amax, min=1e-8) / torch.full_like(amax, 127.0)
    q = torch.clamp(torch.round(xg / xs[:, None, :, None]), -127, 127).to(torch.int8)
    return q.reshape(B, T, C), xs


def _same_pad_conv(x: torch.Tensor, weight: torch.Tensor, groups: int) -> torch.Tensor:
    """Grouped conv1d of x [B, T, C] with k // 2 zeros on each side, cut to
    its first T frames (an even k's trailing frame dropped) -> [B, T, C]."""
    k = weight.shape[-1]
    y = F.conv1d(x.transpose(1, 2), weight, padding=k // 2, groups=groups)
    return y[..., :x.shape[1]].transpose(1, 2)


def pos_conv_gelu_reference(x: torch.Tensor, weight: torch.Tensor, bias: torch.Tensor,
                            groups: int) -> torch.Tensor:
    """Plain version of K16a (`_kernel`, posconv.py:50-61): the weight (the
    nn.Conv1d or the GEMM form) cast to x's dtype, the conv summed in f32,
    + bias in f32, erf GELU, one cast to x's dtype."""
    w = _conv_weight(_gemm_weight(weight, x.shape[-1], groups), groups)
    y = _same_pad_conv(x.float(), w.to(x.dtype).float(), groups) + bias.float()
    return F.gelu(y).to(x.dtype)


def pos_conv_gelu_q8_reference(x: torch.Tensor, wq: torch.Tensor, ws: torch.Tensor,
                               bias: torch.Tensor, groups: int) -> torch.Tensor:
    """Plain version of K16b (posconv.py:110-135, `_kernel_q8` :64-83): the
    codes and scales of `quantize_posconv_input`, the conv of the codes
    summed exactly (f64 holds every sum of 127^2 x k C/G), then f32(acc) *
    f32(xs * ws) + bias in f32, erf GELU, one cast to x's dtype. wq [G, C/G,
    k C/G] int8 and ws [G, C/G] f32 as `quantize_posconv_weight` builds them."""
    B, T, C = x.shape
    xq, xs = quantize_posconv_input(x, groups)
    acc = _same_pad_conv(xq.double(), _conv_weight(wq, groups).double(), groups)
    sc = (xs[:, :, None] * ws[None]).reshape(B, 1, C)  # one rounded product per (b, channel)
    return F.gelu(acc.float() * sc + bias.float()).to(x.dtype)


def _check(name: str, x: torch.Tensor, w: torch.Tensor, w_dtype: torch.dtype,
           bias: torch.Tensor, groups: int, tc: int, max_taps: int) -> int:
    """What `csrc/posconv.cu` takes (CUDA only); returns k."""
    B, T, C = x.shape
    cg = C // groups
    if C % groups or cg != GROUP_WIDTH:
        raise ValueError(f"{name}: the kernel takes {GROUP_WIDTH} channels per group, got "
                         f"C={C}, groups={groups}")
    k = w.shape[-1] // cg if w.dim() == 3 else 0
    if k <= 0 or k % tc or k > max_taps:
        raise ValueError(f"{name}: the kernel takes k a multiple of {tc} up to {max_taps}, "
                         f"got weight {tuple(w.shape)}")
    require(x, "x", x.dtype)
    if x.data_ptr() % 16:
        raise ValueError(f"{name} x: 16-byte aligned rows only")
    require(w, "weight", w_dtype, (groups, cg, k * cg))
    require(bias, "bias", torch.float32, (C,))
    return k


def pos_conv_gelu(x: torch.Tensor, weight: torch.Tensor, bias: torch.Tensor,
                  groups: int = 16) -> torch.Tensor:
    """GELU(grouped same-pad conv1d(x) + bias), the trailing frame dropped:
    K16a.

    x [B, T, C]; weight the nn.Conv1d weight [C, C/G, k] or its tap-major
    GEMM form [G, C/G, k C/G] (`posconv_gemm_weight`, built once at load),
    in x's dtype; bias [C] f32 -> [B, T, C] in x's dtype. CPU tensors run
    the plain version; CUDA tensors launch `csrc/posconv.cu`, which takes
    bf16 x, 64 channels per group and k a multiple of TC up to MAX_TAPS.
    Forward-only."""
    B, T, C = x.shape
    if on_cpu(x, weight, bias):
        return pos_conv_gelu_reference(x, weight, bias, groups)
    if x.dtype != torch.bfloat16:
        raise NotImplementedError(
            f"K16a pos_conv_gelu on the card takes bf16 x, got {x.dtype}: the f32 pos-conv "
            "kernel is not ported yet (ROADMAP.md Queue 2, K16a with f32 x)")
    w = _gemm_weight(weight, C, groups)
    k = _check("K16a pos_conv_gelu", x, w, torch.bfloat16, bias, groups, TC, MAX_TAPS)
    refuse_grad("K16a pos_conv_gelu", x, w, bias)
    out = torch.empty_like(x)
    if not B * T:
        return out
    with torch.cuda.device(x.device):
        launch("s3_posconv", x.data_ptr(), w.data_ptr(), bias.data_ptr(), None, None,
               out.data_ptr(), 0, 0, B, T, C, k, stream_of(x))
    pos_conv_gelu.launches += 1
    return out


pos_conv_gelu.launches = 0  # CUDA launches since the last reset


def _check_x(name: str, x: torch.Tensor, groups: int) -> None:
    """What the K16b quantizer and conv take of x (CUDA only)."""
    C = x.shape[-1]
    if x.dtype not in (torch.bfloat16, torch.float32):
        raise TypeError(f"{name}: dtype {x.dtype}, the kernel takes bf16 or f32")
    if C % groups or C // groups != GROUP_WIDTH:
        raise ValueError(f"{name}: the kernel takes {GROUP_WIDTH} channels per group, "
                         f"got C={C}, groups={groups}")
    require(x, "x", x.dtype)


def _quant_launch(x: torch.Tensor, groups: int, codes: bool):
    """One launch of `csrc/posconv.cu`'s quantizer: (codes [B, T, C] int8 or
    None, scales [B, G] f32)."""
    B, T, C = x.shape
    q = torch.empty(B, T, C, dtype=torch.int8, device=x.device) if codes else None
    xs = torch.empty(B, groups, dtype=torch.float32, device=x.device)
    if B * T:
        launch("s3_posconv_quant", x.data_ptr(), int(x.dtype == torch.float32),
               q.data_ptr() if codes else None, xs.data_ptr(), B, T, C, stream_of(x))
    return q, xs


def posconv_quant(x: torch.Tensor, groups: int):
    """K16b's activation codes on the card (CUDA only): one launch of
    `csrc/posconv.cu`'s quantizer on x [B, T, C] (bf16 or f32, 64 channels
    per group) -> (codes [B, T, C] int8, scales [B, G] f32), as
    `quantize_posconv_input`. K16b itself takes only the scales from this
    kernel and quantizes in its own window load."""
    _check_x("posconv_quant", x, groups)
    return _quant_launch(x, groups, codes=True)


def pos_conv_gelu_q8(x: torch.Tensor, weight, bias: torch.Tensor, groups: int = 16,
                     codes: bool = False):
    """The int8 W8A8 twin of `pos_conv_gelu`: K16b.

    x [B, T, C]; weight the nn.Conv1d weight [C, C/G, k] in f32 (quantized
    here) or its load-time (codes [G, C/G, k C/G] int8, scales [G, C/G] f32)
    pair (`quantize_posconv_weight`); bias [C] f32 -> [B, T, C] in x's
    dtype. CPU tensors run the plain version; CUDA tensors launch
    `csrc/posconv.cu`'s scale pass, then its int8 conv (one launch, which
    counts), which take bf16 or f32 x, 64 channels per group and k a
    multiple of TC_Q8 up to MAX_TAPS_Q8. `codes=True` (test mode) returns
    (out, the activation codes [B, T, C] int8 that the conv's windows held,
    the scales [B, G] f32); on the CPU, the plain version's. Forward-only."""
    wq, ws = _q8_weight(weight, groups)
    if on_cpu(x, wq, ws, bias):
        out = pos_conv_gelu_q8_reference(x, wq, ws, bias, groups)
        return (out, *quantize_posconv_input(x, groups)) if codes else out
    _check_x("K16b pos_conv_gelu_q8", x, groups)
    B, T, C = x.shape
    k = _check("K16b pos_conv_gelu_q8", x, wq, torch.int8, bias, groups, TC_Q8,
               MAX_TAPS_Q8)
    require(ws, "weight scales", torch.float32, (groups, C // groups))
    refuse_grad("K16b pos_conv_gelu_q8", x, ws, bias)
    out = torch.empty_like(x)
    q = torch.zeros(B, T, C, dtype=torch.int8, device=x.device) if codes else None
    xs = torch.empty(B, groups, dtype=torch.float32, device=x.device)
    if B * T:
        with torch.cuda.device(x.device):
            xs = _quant_launch(x, groups, codes=False)[1]
            args = (x.data_ptr(), wq.data_ptr(), bias.data_ptr(), xs.data_ptr(), ws.data_ptr(),
                    out.data_ptr())
            f32 = int(x.dtype == torch.float32)
            if codes:
                launch("s3_posconv_q8_codes", *args, f32, q.data_ptr(), B, T, C, k,
                       stream_of(x))
            else:
                launch("s3_posconv", *args, 1, f32, B, T, C, k, stream_of(x))
        pos_conv_gelu_q8.launches += 1
    return (out, q, xs) if codes else out


pos_conv_gelu_q8.launches = 0  # CUDA launches since the last reset
