"""Dispatch rule and the launches shared by the block kernels.

Every kernel wrapper of the port follows one rule: tensors on the CPU go to
the kernel's plain PyTorch version; CUDA tensors go to the CUDA kernel, or
the wrapper raises. There is no fallback after a failed launch and no switch.

`layer_norm`, `gemm`, `gemm_s8`, `quant_rows`, `quant_rows_bf16`,
`int8_panel` and `ln_gelu_rows` launch the row-LN, GEMM, row-quantization,
int8 panel projection and LN + GELU kernels that the block and front-end
wrappers are built from; they check what the kernels take and raise on
anything else. `int8_projection` routes an int8 projection by row width:
the panel kernel up to PANEL_MAX_C, the quantizer + `gemm_s8` pair beyond.
`layer_norm_f32`, `gelu_tanh` and `ln_gelu_f32` are the plain versions' forms of the Pallas
kernels' in-kernel LayerNorm, tanh GELU and LN + GELU epilogue;
`ln_gelu_from_stats` is that epilogue given a kernel's own LN statistics
(the test modes'), and `int8_panel_reference` the panel's f32 rule in
plain PyTorch.
`refuse_grad` is the refusal every CUDA branch makes: the kernels have no
backward.
"""

from __future__ import annotations

import math

import torch
import torch.nn.functional as F

from ..ops.quant import int_mm, quantize_rows
from ._build import launch

GEMM_RAW, GEMM_QKV, GEMM_LINEAR = 0, 1, 2  # csrc/gemm_s8.cu epilogue modes
LN_EPS = 1e-5  # the Pallas kernels' LayerNorm epsilon


def _ptr(t: torch.Tensor | None):
    return t.data_ptr() if t is not None else None


def layer_norm_f32(x: torch.Tensor, ln) -> torch.Tensor:
    """f32 LayerNorm over the last axis as the Pallas kernels write it
    (s3prl_tpu/kernels/ffn.py:63-66): (x - mean) * rsqrt(var + eps) * g + b
    with the biased variance; the reciprocal square root is 1 / sqrt, as
    the CUDA quantizer computes it."""
    x = x.float()
    mean = x.mean(-1, keepdim=True)
    var = ((x - mean) ** 2).mean(-1, keepdim=True)
    return (x - mean) * (1.0 / torch.sqrt(var + LN_EPS)) * ln[0].float() + ln[1].float()


def gelu_tanh(y: torch.Tensor) -> torch.Tensor:
    """tanh-approximate GELU in f32 (s3prl_tpu/kernels/conv_frontend.py:55-57)."""
    c = math.sqrt(2.0 / math.pi)
    return 0.5 * y * (1.0 + torch.tanh(c * (y + 0.044715 * y * y * y)))


def ln_gelu_f32(y: torch.Tensor, scale: torch.Tensor, bias: torch.Tensor,
                gelu_mode: str = "erf") -> torch.Tensor:
    """The front-end kernels' row epilogue in f32 (s3prl_tpu/kernels/
    conv_frontend.py:80-85): `layer_norm_f32`, then GELU, exact ("erf") or
    tanh-approximate ("tanh"); no cast."""
    y = layer_norm_f32(y, (scale, bias))
    return gelu_tanh(y) if gelu_mode == "tanh" else F.gelu(y)


def ln_gelu_from_stats(y: torch.Tensor, stats: torch.Tensor, scale: torch.Tensor,
                       bias: torch.Tensor) -> torch.Tensor:
    """`ln_gelu_f32`'s LN and erf GELU of y [R, C] given its statistics
    [R, 2] (mean, 1 / sqrt(var + eps)), as a kernel's test mode returns
    them: (y - mean) * rstd * scale + bias, then GELU, in f32."""
    z = (y.float() - stats[:, :1]) * stats[:, 1:] * scale.float() + bias.float()
    return F.gelu(z)


def refuse_grad(name: str, *tensors) -> None:
    """Raises when autograd would record a kernel call: the CUDA kernels
    write their outputs outside autograd and have no backward, so a
    gradient through them would silently be missing."""
    if torch.is_grad_enabled() and any(t is not None and t.requires_grad for t in tensors):
        raise RuntimeError(
            f"{name} is forward-only: call it under torch.no_grad() or "
            "torch.inference_mode(), or on CPU tensors")


def on_cpu(*tensors: torch.Tensor) -> bool:
    """True when every tensor lies on the CPU (plain version), False when
    every one lies on a CUDA device (kernel); raises for anything else."""
    kinds = {t.device.type for t in tensors}
    if kinds == {"cpu"}:
        return True
    if kinds == {"cuda"} and len({t.device for t in tensors}) == 1:
        return False
    raise ValueError(
        f"tensors on {sorted(str(t.device) for t in tensors)}: the CUDA "
        "kernels take tensors on one CUDA device, their plain versions CPU "
        "tensors")


def require(t: torch.Tensor, name: str, dtype: torch.dtype, shape=None) -> None:
    if t.dtype != dtype:
        raise TypeError(f"{name}: dtype {t.dtype}, the kernel takes {dtype}")
    if shape is not None and tuple(t.shape) != tuple(shape):
        raise ValueError(f"{name}: shape {tuple(t.shape)}, expected {tuple(shape)}")
    if not t.is_contiguous():
        raise ValueError(f"{name}: the kernel takes contiguous tensors")


def stream_of(t: torch.Tensor) -> int:
    return torch.cuda.current_stream(t.device).cuda_stream


def _row_layout(a: torch.Tensor, name: str, align: int):
    """(M, K, lda, rows per group, group stride) of a GEMM's A operand: a
    matrix [M, K] or a row-group view [G, R, K] (row m = (g, r) starts g *
    stride(0) + r * stride(1) elements in; the rows may overlap, as a
    stride-2 conv's im2col rows do), unit stride along K, every row at a
    16-byte boundary (`align` elements)."""
    if a.dim() == 2:
        (M, K), lda, rows, gstride = a.shape, a.stride(0), a.shape[0], 0
    else:
        G, rows, K = a.shape
        M, lda, gstride = G * rows, a.stride(1), a.stride(0)
    if a.stride(-1) != 1 or lda % align or gstride % align or a.data_ptr() % 16:
        raise ValueError(f"{name}: rows must be unit-stride, 16-byte aligned")
    return M, K, lda, max(rows, 1), gstride


def layer_norm(x: torch.Tensor, scale: torch.Tensor, bias: torch.Tensor,
               eps: float = 1e-5) -> torch.Tensor:
    """x [R, C] bf16 or f32 -> bf16 LN(x), f32 statistics (CUDA only)."""
    rows, cols = x.shape
    if x.dtype not in (torch.bfloat16, torch.float32):
        raise TypeError(f"layer_norm: dtype {x.dtype}, the kernel takes bf16 or f32")
    require(x, "layer_norm x", x.dtype)
    require(scale, "layer_norm scale", torch.float32, (cols,))
    require(bias, "layer_norm bias", torch.float32, (cols,))
    out = torch.empty(rows, cols, dtype=torch.bfloat16, device=x.device)
    if rows:
        launch("s3_layernorm", x.data_ptr(), int(x.dtype == torch.float32),
               scale.data_ptr(), bias.data_ptr(), out.data_ptr(), rows, cols,
               float(eps), stream_of(x))
    return out


def gemm(a: torch.Tensor, w: torch.Tensor, bias: torch.Tensor | None = None,
         residual: torch.Tensor | None = None, gelu: bool = False,
         out_f32: bool = False) -> torch.Tensor:
    """a [M, K] bf16 @ w[N, K]^T (nn.Linear layout) [+ bias f32 [N]]
    [-> erf GELU] [+ residual bf16 [M, N]] -> bf16 (or f32) [M, N], f32
    accumulation (CUDA only), on `csrc/gemm_bf16.cu`. a may be a row-group
    view [G, R, K] of M = G * R rows (`_row_layout`; rows that overlap, as
    a k = 3 conv's im2col rows, need gcd(lda, K) a multiple of 64, so that
    each of at most three runs of K is read through its own tensor map)."""
    if a.dtype != torch.bfloat16:
        raise TypeError(f"gemm a: dtype {a.dtype}, the kernel takes {torch.bfloat16}")
    M, K, lda, a_rows, a_gstride = _row_layout(a, "gemm a", 8)
    N = w.shape[0]
    require(w, "gemm w", torch.bfloat16, (N, K))
    if bias is not None:
        require(bias, "gemm bias", torch.float32, (N,))
    if residual is not None:
        require(residual, "gemm residual", torch.bfloat16, (M, N))
    if K % 8 or N % 8:
        raise ValueError(f"gemm: K={K} and N={N} must be multiples of 8")
    if lda < K and (K // math.gcd(lda, K) > 3 or math.gcd(lda, K) % 64):
        raise ValueError(f"gemm: rows {lda} elements apart overlap their K={K} in a way the "
                         "kernel's tensor maps cannot split")
    if any(t is not None and t.data_ptr() % 16 for t in (w, bias, residual)):
        raise ValueError("gemm: w, bias and residual must start at 16-byte boundaries")
    out = torch.empty(M, N, dtype=torch.float32 if out_f32 else torch.bfloat16,
                      device=a.device)
    if M:
        launch("s3_gemm_bf16", a.data_ptr(), lda, a_rows, a_gstride, w.data_ptr(),
               _ptr(bias), _ptr(residual), out.data_ptr(), int(out_f32), int(gelu), M, N, K,
               stream_of(a))
    return out


def gemm_s8(a: torch.Tensor, w: torch.Tensor, *, mode: int = GEMM_RAW,
            row_scale: torch.Tensor | None = None, col_scale: torch.Tensor | None = None,
            bias: torch.Tensor | None = None, acc_in: torch.Tensor | None = None,
            residual: torch.Tensor | None = None, gelu: bool = False,
            out_f32: bool = False, out: torch.Tensor | None = None) -> torch.Tensor:
    """a [M, K] int8 @ w[N, K]^T int8 (nn.Linear layout) with exact int32
    sums and one of csrc/gemm_s8.cu's epilogues (CUDA only):
    GEMM_RAW -> int32; GEMM_QKV -> bf16 bf16(bf16(bf16(acc) * bf16(rs * cs))
    + bf16(bias)); GEMM_LINEAR -> f32(acc) * rs * cs [acc_in +] [+ bias]
    [tanh GELU] [+ residual], f32 or bf16. a and w may be column ranges of
    wider matrices (row strides a.stride(0), w.stride(0)), and a a row-group
    view [G, R, K] of M = G * R rows (`_row_layout`); `out` (may be
    `acc_in`) receives the result."""
    for t, name in ((a, "a"), (w, "w")):
        if t.dtype != torch.int8:
            raise TypeError(f"gemm_s8 {name}: dtype {t.dtype}, the kernel takes int8")
    M, K, lda, a_rows, a_gstride = _row_layout(a, "gemm_s8 a", 16)
    N, Kw = w.shape
    if Kw != K:
        raise ValueError(f"gemm_s8: a has K={K}, w has K={Kw}")
    _row_layout(w, "gemm_s8 w", 16)
    if K % 16 or N % 8:
        raise ValueError(f"gemm_s8: K={K} must be a multiple of 16, N={N} of 8")
    if mode != GEMM_RAW:
        require(row_scale, "gemm_s8 row_scale", torch.float32, (M,))
        require(col_scale, "gemm_s8 col_scale", torch.float32, (N,))
    if mode == GEMM_QKV and bias is None:
        raise ValueError("gemm_s8: the QKV epilogue needs a bias")
    if bias is not None:
        require(bias, "gemm_s8 bias", torch.float32, (N,))
    if acc_in is not None:
        require(acc_in, "gemm_s8 acc_in", torch.float32, (M, N))
    if residual is not None:
        require(residual, "gemm_s8 residual", torch.bfloat16, (M, N))
    dtype = {GEMM_RAW: torch.int32, GEMM_QKV: torch.bfloat16}.get(
        mode, torch.float32 if out_f32 else torch.bfloat16)
    if out is None:
        out = torch.empty(M, N, dtype=dtype, device=a.device)
    require(out, "gemm_s8 out", dtype, (M, N))
    if M:
        launch("s3_gemm_s8", a.data_ptr(), lda, a_rows, a_gstride, w.data_ptr(), w.stride(0),
               M, N, K,
               _ptr(row_scale), _ptr(col_scale), _ptr(bias), _ptr(acc_in), _ptr(residual),
               out.data_ptr(), mode, int(gelu), int(out_f32), stream_of(a))
    return out


def quant_rows(x: torch.Tensor, ln=None, lo: int = 0, hi: int | None = None,
               q: torch.Tensor | None = None, scale: torch.Tensor | None = None):
    """Dynamic per-row int8 of x [R, D] (bf16 or f32) over columns [lo, hi),
    after an f32 LayerNorm when `ln` = (scale, bias) is given (CUDA only).
    Codes go to q [R, D] int8 at the same places, scales to scale [R] f32;
    returns (q, scale)."""
    rows, cols = x.shape
    hi = cols if hi is None else hi
    if x.dtype not in (torch.bfloat16, torch.float32):
        raise TypeError(f"quant_rows: dtype {x.dtype}, the kernel takes bf16 or f32")
    require(x, "quant_rows x", x.dtype)
    if not 0 <= lo < hi <= cols:
        raise ValueError(f"quant_rows: column range [{lo}, {hi}) of {cols}")
    if ln is not None:
        require(ln[0], "quant_rows ln scale", torch.float32, (cols,))
        require(ln[1], "quant_rows ln bias", torch.float32, (cols,))
    q = torch.empty(rows, cols, dtype=torch.int8, device=x.device) if q is None else q
    scale = torch.empty(rows, dtype=torch.float32, device=x.device) if scale is None else scale
    require(q, "quant_rows q", torch.int8, (rows, cols))
    require(scale, "quant_rows scale", torch.float32, (rows,))
    if rows:
        launch("s3_quant_rows", x.data_ptr(), int(x.dtype == torch.float32), cols, lo, hi,
               _ptr(ln[0] if ln is not None else None), _ptr(ln[1] if ln is not None else None),
               LN_EPS, q.data_ptr(), scale.data_ptr(), rows, stream_of(x))
    return q, scale


def quant_rows_bf16(x: torch.Tensor):
    """K1's context quantization of x [R, C] bf16, in bf16 (CUDA only) ->
    (int8 [R, C], f32 [R] holding the bf16 scales)."""
    rows, cols = x.shape
    require(x, "quant_rows_bf16 x", torch.bfloat16)
    q = torch.empty(rows, cols, dtype=torch.int8, device=x.device)
    scale = torch.empty(rows, dtype=torch.float32, device=x.device)
    if rows:
        launch("s3_quant_rows_bf16", x.data_ptr(), cols, q.data_ptr(), scale.data_ptr(),
               rows, stream_of(x))
    return q, scale


RULE_F32, RULE_CTX = 0, 1  # csrc/int8_panel.cu's row rules: quant_rows.cu's f32 and bf16 ones
# Rows up to this wide stay on chip as one int8 panel (csrc/int8_panel.cu:
# 128 rows x 1,024 codes = 128 KB of shared memory); wider rows take the
# quant_rows.cu + gemm_s8.cu pair (`int8_projection`).
PANEL_MAX_C = 1024


def int8_panel(x: torch.Tensor, w: torch.Tensor, col_scale: torch.Tensor,
               bias: torch.Tensor, *, ln=None, rule: int = RULE_F32,
               mode: int = GEMM_LINEAR, residual: torch.Tensor | None = None,
               out_f32: bool = False, codes: bool = False):
    """x [M, C] bf16 (C <= PANEL_MAX_C, a multiple of 16) -> its per-row
    int8 projection by w [N, C] int8 (scales col_scale [N] f32, bias [N]
    f32), one launch of csrc/int8_panel.cu (CUDA only): the rows quantized
    on chip by `rule` (RULE_F32 after an f32 LayerNorm when `ln` = (scale,
    bias) is given, or K1's bf16 context rule RULE_CTX), then GEMM_QKV ->
    bf16, or GEMM_LINEAR [+ residual bf16 [M, N]] -> bf16 or f32. f32 x
    (K6's context) takes RULE_F32 without the LN and GEMM_LINEAR. With
    `codes` (a test mode) also returns the codes [M, C] int8, the scales
    [M] f32 and, with the LN, its statistics [M, 2] (mean, 1 / sqrt(var +
    eps)) f32 as the kernel computed them: (out, q, scale, stats or None)."""
    M, C = x.shape
    N = w.shape[0]
    if x.dtype not in (torch.bfloat16, torch.float32):
        raise TypeError(f"int8_panel x: dtype {x.dtype}, the kernel takes bf16 or f32")
    require(x, "int8_panel x", x.dtype)
    x_f32 = x.dtype == torch.float32
    if x_f32 and (rule != RULE_F32 or ln is not None or mode != GEMM_LINEAR):
        raise ValueError("int8_panel: f32 rows take the f32 rule without an LN, GEMM_LINEAR")
    require(w, "int8_panel w", torch.int8, (N, C))
    require(col_scale, "int8_panel col_scale", torch.float32, (N,))
    require(bias, "int8_panel bias", torch.float32, (N,))
    if C > PANEL_MAX_C or C % 16 or N % 8:
        raise ValueError(f"int8_panel: C={C} must be a multiple of 16 up to {PANEL_MAX_C}, "
                         f"N={N} a multiple of 8")
    if ln is not None:
        if rule != RULE_F32:
            raise ValueError("int8_panel: the LN prologue takes the f32 rule")
        require(ln[0], "int8_panel ln scale", torch.float32, (C,))
        require(ln[1], "int8_panel ln bias", torch.float32, (C,))
    if mode not in (GEMM_QKV, GEMM_LINEAR) or (mode == GEMM_QKV and (residual is not None
                                                                     or out_f32)):
        raise ValueError("int8_panel: GEMM_QKV (bf16 out, no residual) or GEMM_LINEAR")
    if residual is not None:
        require(residual, "int8_panel residual", torch.bfloat16, (M, N))
    tensors = (x, w, col_scale, bias, residual) + (tuple(ln) if ln is not None else ())
    if any(t is not None and t.data_ptr() % 16 for t in tensors):
        raise ValueError("int8_panel: every tensor must start at a 16-byte boundary")
    out = torch.empty(M, N, dtype=torch.float32 if out_f32 else torch.bfloat16,
                      device=x.device)
    q = torch.empty(M, C, dtype=torch.int8, device=x.device) if codes else None
    scale = torch.empty(M, dtype=torch.float32, device=x.device) if codes else None
    stats = torch.empty(M, 2, dtype=torch.float32, device=x.device) \
        if codes and ln is not None else None
    if M:
        launch("s3_int8_panel", x.data_ptr(), int(x_f32), M, C, rule,
               _ptr(ln[0] if ln is not None else None), _ptr(ln[1] if ln is not None else None),
               LN_EPS, w.data_ptr(), N, col_scale.data_ptr(), bias.data_ptr(), _ptr(residual),
               out.data_ptr(), mode, int(out_f32), _ptr(q), _ptr(scale), _ptr(stats),
               stream_of(x))
    return (out, q, scale, stats) if codes else out


def int8_panel_reference(x: torch.Tensor, w: torch.Tensor, col_scale: torch.Tensor,
                         bias: torch.Tensor, residual: torch.Tensor | None = None,
                         out_f32: bool = False):
    """Plain version of `int8_panel`'s f32 rule without the LN in
    GEMM_LINEAR (K6's out-proj): x [M, C] (f32 or bf16) -> (out [M, N] bf16
    or f32, codes [M, C] int8, scales [M] f32), with `quantize_rows`'
    codes, exact int32 sums and ((f32(acc) * s) * col_scale + bias) [+
    residual] in f32, cast once."""
    q, s = quantize_rows(x.float())
    y = int_mm(q, w).float() * s * col_scale + bias
    if residual is not None:
        y = y + residual.float()
    return (y if out_f32 else y.to(torch.bfloat16)), q, s[:, 0]


def int8_projection(x: torch.Tensor, w: torch.Tensor, col_scale: torch.Tensor,
                    bias: torch.Tensor, *, ln=None, rule: int = RULE_F32,
                    mode: int = GEMM_LINEAR, residual: torch.Tensor | None = None,
                    out_f32: bool = False) -> torch.Tensor:
    """`int8_panel`'s function at any row width, routed by shape (CUDA
    only): rows up to PANEL_MAX_C wide take the panel kernel (one launch);
    wider rows take `quant_rows` (RULE_F32, with the LN; bf16 or f32 x) or
    `quant_rows_bf16` (RULE_CTX), then `gemm_s8` with the same epilogue."""
    if rule == RULE_CTX and ln is not None:
        raise ValueError("int8_projection: the LN prologue takes the f32 rule")
    if x.shape[1] <= PANEL_MAX_C:
        return int8_panel(x, w, col_scale, bias, ln=ln, rule=rule, mode=mode,
                          residual=residual, out_f32=out_f32)
    x8, xs = quant_rows_bf16(x) if rule == RULE_CTX else quant_rows(x, ln=ln)
    return gemm_s8(x8, w, mode=mode, row_scale=xs, col_scale=col_scale, bias=bias,
                   residual=residual, out_f32=out_f32)


LN_GELU_OUT = {torch.bfloat16: 0, torch.float32: 1, torch.int8: 2}  # csrc/ln_gelu.cu out kinds


def ln_gelu_rows(x: torch.Tensor, scale: torch.Tensor, bias: torch.Tensor,
                 gelu_mode: str = "erf", out_dtype: torch.dtype | None = None):
    """GELU(LN(x)) of x [R, 512] (bf16 or f32) in f32, one launch of
    csrc/ln_gelu.cu (CUDA only): cast once to `out_dtype` (x.dtype by
    default; bf16 or f32) -> [R, 512], or with out_dtype=torch.int8 the
    per-row int8 codes [R, 512] and their f32 scales [R]."""
    rows, cols = x.shape
    out_dtype = out_dtype or x.dtype
    if x.dtype not in (torch.bfloat16, torch.float32) or out_dtype not in LN_GELU_OUT:
        raise TypeError(f"ln_gelu_rows: {x.dtype} -> {out_dtype}, the kernel takes bf16 or f32 "
                        "to bf16, f32 or int8")
    require(x, "ln_gelu_rows x", x.dtype, (rows, 512))
    require(scale, "ln_gelu_rows scale", torch.float32, (512,))
    require(bias, "ln_gelu_rows bias", torch.float32, (512,))
    out = torch.empty(rows, 512, dtype=out_dtype, device=x.device)
    q_scale = torch.empty(rows, dtype=torch.float32, device=x.device) \
        if out_dtype == torch.int8 else None
    if rows:
        launch("s3_ln_gelu", x.data_ptr(), int(x.dtype == torch.float32), scale.data_ptr(),
               bias.data_ptr(), int(gelu_mode == "tanh"), out.data_ptr(), LN_GELU_OUT[out_dtype],
               _ptr(q_scale), rows, stream_of(x))
    return out if q_scale is None else (out, q_scale)
