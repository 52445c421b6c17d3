"""Whole FFN blocks: ports of the Pallas kernels `fused_int8_ffn` (int8
W8A8, K2, s3prl_tpu/kernels/ffn.py:160) and `fused_bf16_ffn` (K5, :350).

K5, bf16:
[LN ->] fc1 + b1 -> erf GELU -> fc2 + b2 [+ x] [-> LN]. The TPU kernel keeps
the [rows, FFN] intermediate in VMEM and streams the weights in FFN panels
into an f32 accumulator; the port is two or three launches behind one
function: `csrc/layernorm.cu` (the LN prologue, bf16 out), `csrc/gemm_bf16.cu`
for fc1 with the bias + GELU + bf16 epilogue, and for fc2 with bias [+ x]
(f32 out when ``postnorm``, then `csrc/layernorm.cu`). The panel-wise f32
sum is the GEMM's K loop. The [rows, FFN] intermediate goes through device
memory (131 MB at B=32 x 10 s); keeping it on chip is later work.

K2, int8 (the serving default): [LN ->] row-quant -> int8 fc1 -> dequant +
b1 -> tanh GELU -> per-chunk row requant -> int8 fc2 summed in f32 over the
chunks -> + b2 [+ x] [-> LN]. The FFN axis is cut into chunks by the JAX
rule (`_chunk_for`: one chunk up to 3072, else 2048 wide), and each chunk's
rows get their own requant scale, so at HuBERT-Large's F=4096 there are two.
The TPU kernel keeps each chunk of the intermediate in VMEM; the port is a few
launches behind one function, with the intermediate in device memory:
`csrc/quant_rows.cu` ([LN +] quantization of x), `csrc/gemm_s8.cu` for fc1
over all F columns with the scale + bias + tanh GELU epilogue into f32
[rows, F] (262 MB at B=32 x 10 s; the Pallas kernel requantizes the
unrounded f32 value), `csrc/quant_rows.cu` once per chunk, then
`csrc/gemm_s8.cu` once per chunk, each adding its dequantized sum to the
f32 output in the Pallas order (the last adds b2 [+ x]), and with
``postnorm`` `csrc/layernorm.cu`.

K12 `fused_int8_linear` (ffn.py:238, pallas_call :216), the int8
projection of the ``qkv_fuse`` and ``full_fuse`` options: [LN ->] row-quant
-> int8 GEMM -> ((f32(acc) * xs) * ws + b) [+ residual] in f32, one cast.
One launch of `csrc/int8_panel.cu` (`int8_projection`): a block keeps 128
whole rows on chip, runs the f32 LN prologue (unrounded) and the f32
quantizer there, as the Pallas cell does, and the linear epilogue (never
K1's triple-rounding QKV one, whatever N is). Rows wider than PANEL_MAX_C
take `csrc/quant_rows.cu` + `csrc/gemm_s8.cu`.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

from ..ops.quant import as_quantized_cols, int_mm, quantize_rows
from ._common import (GEMM_LINEAR, gelu_tanh, gemm, gemm_s8, int8_projection, layer_norm,
                      layer_norm_f32, on_cpu, quant_rows, refuse_grad, require)

CHUNK = 2048  # FFN columns per chunk when the FFN is wider than 3072 (ffn.py:50)


def _chunk_for(ffn: int) -> int:
    """The JAX rule (ffn.py:53-60): one chunk when the FFN dim is at most
    3072, else CHUNK-wide chunks."""
    return ffn if ffn <= 3072 else CHUNK


def _ffn_chunk_bounds(ffn: int):
    """(lo, hi) chunks covering all of the FFN dim; the last may be shorter."""
    chunk = _chunk_for(ffn)
    return tuple((lo, min(lo + chunk, ffn)) for lo in range(0, ffn, chunk))


def _check_postnorm(ln, residual: bool, postnorm: bool) -> None:
    if postnorm and (ln is None or not residual):
        raise ValueError("postnorm is LN(x + ffn(x)): it needs ln and residual")


def fused_bf16_ffn_reference(x, w1, b1, w2, b2, ln=None, residual: bool = False,
                             postnorm: bool = False):
    """Plain version with the Pallas kernel's cast points: f32 LN, bf16 fc1
    operands with f32 accumulation, bias + erf GELU in f32, bf16 fc2
    operands with f32 accumulation, bias [+ x] [LN] in f32, one cast at the
    end."""
    _check_postnorm(ln, residual, postnorm)
    x_in = x.float()
    xn = x_in
    if ln is not None and not postnorm:
        xn = F.layer_norm(x_in, (x.shape[-1],), ln[0].float(), ln[1].float(), eps=1e-5)
    h = xn.to(torch.bfloat16).float() @ w1.to(torch.bfloat16).float().t() + b1.float()
    h = F.gelu(h).to(torch.bfloat16).float()
    y = h @ w2.to(torch.bfloat16).float().t() + b2.float()
    if residual:
        y = y + x_in
    if postnorm:
        y = F.layer_norm(y, (y.shape[-1],), ln[0].float(), ln[1].float(), eps=1e-5)
    return y.to(x.dtype)


def fused_bf16_ffn(x, w1, b1, w2, b2, ln=None, residual: bool = False,
                   postnorm: bool = False):
    """x [B, T, C] -> [x +] fc2(gelu(fc1([LN](x)))), or with ``postnorm``
    LN(x + fc2(gelu(fc1(x)))), in bf16.

    w1 [F, C] and w2 [C, F] bf16 in nn.Linear layout (the transposes of the
    JAX kernel's [C, F] and [F, C]); b1 [F], b2 [C] and ln = (scale, bias)
    f32. CPU tensors run the plain version; CUDA tensors launch the kernels,
    which take bf16 x and C, F multiples of 8."""
    _check_postnorm(ln, residual, postnorm)
    tensors = (x, w1, b1, w2, b2) + (tuple(ln) if ln is not None else ())
    if on_cpu(*tensors):
        return fused_bf16_ffn_reference(x, w1, b1, w2, b2, ln, residual, postnorm)
    B, T, C = x.shape
    require(x, "x", torch.bfloat16)
    refuse_grad("K5 fused_bf16_ffn", *tensors)
    with torch.cuda.device(x.device):
        x2 = x.view(B * T, C)
        h = layer_norm(x2, ln[0], ln[1]) if ln is not None and not postnorm else x2
        h = gemm(h, w1, b1, gelu=True)
        y = gemm(h, w2, b2, residual=x2 if residual else None, out_f32=postnorm)
        if postnorm:
            y = layer_norm(y, ln[0], ln[1])
    fused_bf16_ffn.launches += 1
    return y.view(B, T, C)


fused_bf16_ffn.launches = 0  # CUDA launches since the last reset


def fused_int8_ffn_reference(x, w1, b1, w2, b2, ln=None, residual: bool = False,
                             postnorm: bool = False):
    """Plain version of K2 with the Pallas kernel's cast points: [f32 LN ->]
    f32 per-row quantization; per chunk, exact int32 fc1 sums dequantized as
    f32(acc) * xs * w1s + b1, tanh GELU in f32, the chunk's own per-row
    requant, exact int32 fc2 sums added as acc + f32(acc2) * hs * w2s; then
    + b2 [+ x] [LN] in f32 and one cast. w1, w2: nn.Linear weights or
    (codes, scales) pairs."""
    _check_postnorm(ln, residual, postnorm)
    w1q, w1s = as_quantized_cols(w1)
    w2q, w2s = as_quantized_cols(w2)
    B, T, C = x.shape
    x_in = x.float().reshape(B * T, C)
    xn = layer_norm_f32(x_in, ln) if ln is not None and not postnorm else x_in
    x8, xs = quantize_rows(xn)
    acc = torch.zeros(B * T, C, device=x.device)
    for lo, hi in _ffn_chunk_bounds(w1q.shape[0]):
        h = int_mm(x8, w1q[lo:hi]).float() * xs * w1s[lo:hi] + b1[lo:hi].float()
        h8, hs = quantize_rows(gelu_tanh(h))
        acc = acc + int_mm(h8, w2q[:, lo:hi]).float() * hs * w2s
    out = acc + b2.float()
    if residual:
        out = out + x_in
    if postnorm:
        out = layer_norm_f32(out, ln)
    return out.to(x.dtype).view(B, T, C)


def fused_int8_ffn(x, w1, b1, w2, b2, ln=None, residual: bool = False,
                   postnorm: bool = False):
    """x [B, T, C] -> [x +] fc2(gelu_tanh(fc1([LN](x)))) with int8 W8A8
    products, or with ``postnorm`` LN(x + fc2(gelu_tanh(fc1(x)))), in bf16: K2.

    w1, w2: the cached (codes [F, C] / [C, F] int8, scales [F] / [C] f32)
    pairs in nn.Linear layout (a raw weight is quantized here); b1 [F], b2
    [C] and ln = (scale, bias) f32. CPU tensors run the plain version; CUDA
    tensors launch the kernels, which take bf16 x, C a multiple of 16 and F
    of 16."""
    _check_postnorm(ln, residual, postnorm)
    w1q, w1s = as_quantized_cols(w1)
    w2q, w2s = as_quantized_cols(w2)
    tensors = (x, w1q, w1s, b1, w2q, w2s, b2) + (tuple(ln) if ln is not None else ())
    if on_cpu(*tensors):
        return fused_int8_ffn_reference(x, (w1q, w1s), b1, (w2q, w2s), b2, ln, residual,
                                        postnorm)
    B, T, C = x.shape
    Fd = w1q.shape[0]
    require(x, "x", torch.bfloat16)
    require(w1q, "w1 codes", torch.int8, (Fd, C))
    require(w2q, "w2 codes", torch.int8, (C, Fd))
    refuse_grad("K2 fused_int8_ffn", *tensors)
    R = B * T
    bounds = _ffn_chunk_bounds(Fd)
    with torch.cuda.device(x.device):
        x2 = x.view(R, C)
        x8, xs = quant_rows(x2, ln=ln if not postnorm else None)
        h = gemm_s8(x8, w1q, mode=GEMM_LINEAR, row_scale=xs, col_scale=w1s, bias=b1,
                    gelu=True, out_f32=True)
        h8 = torch.empty(R, Fd, dtype=torch.int8, device=x.device)
        hs = torch.empty(len(bounds), R, dtype=torch.float32, device=x.device)
        for i, (lo, hi) in enumerate(bounds):
            quant_rows(h, lo=lo, hi=hi, q=h8, scale=hs[i])
        del h
        acc = torch.empty(R, C, dtype=torch.float32, device=x.device)
        for i, (lo, hi) in enumerate(bounds):
            last = i == len(bounds) - 1
            out_f32 = postnorm or not last
            y = gemm_s8(h8[:, lo:hi], w2q[:, lo:hi], mode=GEMM_LINEAR, row_scale=hs[i],
                        col_scale=w2s, acc_in=acc if i else None,
                        bias=b2 if last else None,
                        residual=x2 if last and residual else None, out_f32=out_f32,
                        out=acc if out_f32 else None)
        if postnorm:
            y = layer_norm(y, ln[0], ln[1])
    fused_int8_ffn.launches += 1
    return y.view(B, T, C)


fused_int8_ffn.launches = 0  # CUDA launches since the last reset


def fused_int8_linear_reference(x, w, b, ln=None, residual=None):
    """Plain version of K12 with the Pallas kernel's cast points (ffn.py:
    185-197): [f32 LN, eps 1e-5, not rounded ->] f32 per-row quantization
    (max(absmax, 1e-8) / 127, round half to even), exact int32 sums,
    ((f32(acc) * xs) * ws + b) [+ residual] in f32, one cast to x.dtype.
    w: an nn.Linear weight [N, C] or its (codes, scales) pair."""
    wq, ws = as_quantized_cols(w)
    B, T, C = x.shape
    N = wq.shape[0]
    x_in = x.float().reshape(B * T, C)
    x8, xs = quantize_rows(layer_norm_f32(x_in, ln) if ln is not None else x_in)
    y = int_mm(x8, wq).float() * xs * ws + b.float()
    if residual is not None:
        y = y + residual.float().reshape(B * T, N)
    return y.to(x.dtype).view(B, T, N)


def fused_int8_linear(x, w, b, ln=None, residual=None):
    """x [B, T, C] -> [LN](x) @ w^T + b [+ residual], int8 W8A8, in x's
    dtype: K12. The argument order is the JAX function's.

    w: the cached (codes [N, C] int8, scales [N] f32) pair in nn.Linear
    layout (a raw weight is quantized here); b [N] and ln = (scale [C], bias
    [C]) f32; residual [B, T, N]. CPU tensors run the plain version; CUDA
    tensors launch `csrc/int8_panel.cu` (C <= PANEL_MAX_C; wider rows
    `csrc/quant_rows.cu` and `csrc/gemm_s8.cu`), which take bf16 x and
    residual, C a multiple of 16 and N of 8. Forward-only."""
    wq, ws = as_quantized_cols(w)
    tensors = ((x, wq, ws, b) + (tuple(ln) if ln is not None else ())
               + ((residual,) if residual is not None else ()))
    if on_cpu(*tensors):
        return fused_int8_linear_reference(x, (wq, ws), b, ln, residual)
    B, T, C = x.shape
    N = wq.shape[0]
    require(x, "x", torch.bfloat16)
    require(wq, "w codes", torch.int8, (N, C))
    if residual is not None:
        require(residual, "residual", torch.bfloat16, (B, T, N))
    refuse_grad("K12 fused_int8_linear", *tensors)
    with torch.cuda.device(x.device):
        y = int8_projection(x.view(B * T, C), wq, ws, b, ln=ln,
                            residual=residual.view(B * T, N) if residual is not None else None)
    fused_int8_linear.launches += 1
    return y.view(B, T, N)


fused_int8_linear.launches = 0  # CUDA launches since the last reset
