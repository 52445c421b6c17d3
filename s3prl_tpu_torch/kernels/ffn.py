"""Whole FFN block in bf16: port of the Pallas kernel `fused_bf16_ffn`
(s3prl_tpu/kernels/ffn.py:350).

[LN ->] fc1 + b1 -> erf GELU -> fc2 + b2 [+ x] [-> LN]. The TPU kernel keeps
the [rows, FFN] intermediate in VMEM and streams the weights in FFN panels
into an f32 accumulator; the port is two or three launches behind one
function: `csrc/layernorm.cu` (the LN prologue, bf16 out), `csrc/gemm_bf16.cu`
for fc1 with the bias + GELU + bf16 epilogue, and for fc2 with bias [+ x]
(f32 out when ``postnorm``, then `csrc/layernorm.cu`). The panel-wise f32
sum is the GEMM's K loop. The [rows, FFN] intermediate goes through device
memory (131 MB at B=32 x 10 s); keeping it on chip is later work.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

from ._common import gemm, layer_norm, on_cpu, require


def fused_bf16_ffn_reference(x, w1, b1, w2, b2, ln=None, residual: bool = False,
                             postnorm: bool = False):
    """Plain version with the Pallas kernel's cast points: f32 LN, bf16 fc1
    operands with f32 accumulation, bias + erf GELU in f32, bf16 fc2
    operands with f32 accumulation, bias [+ x] [LN] in f32, one cast at the
    end."""
    if postnorm and (ln is None or not residual):
        raise ValueError("postnorm is LN(x + ffn(x)): it needs ln and residual")
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
    if postnorm and (ln is None or not residual):
        raise ValueError("postnorm is LN(x + ffn(x)): it needs ln and residual")
    tensors = (x, w1, b1, w2, b2) + (tuple(ln) if ln is not None else ())
    if on_cpu(*tensors):
        return fused_bf16_ffn_reference(x, w1, b1, w2, b2, ln, residual, postnorm)
    B, T, C = x.shape
    require(x, "x", torch.bfloat16)
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
