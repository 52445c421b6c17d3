"""Dynamic int8 W8A8 scheme of the serving path (port of
s3prl_tpu/ops/quant.py:29-94).

- weights: symmetric per-output-channel int8, quantized ONCE from the f32
  weights when the model is loaded (the port's form of the JAX package's
  ``qcache`` collection: `EncoderLayer.build_qcache`);
- activations: symmetric dynamic per-row int8 (absmax / 127);
- products: int8 x int8 -> exact int32, dequantized as
  ``f32(acc) * row_scale * col_scale (+ bias)``.

Scales are clamped at 1e-8 and divide (never a multiply by the
reciprocal), and codes round half to even (``torch.round``, as
``jnp.round``), so the codes and scales equal the JAX package's bit for bit.

The port's weights are in nn.Linear layout [N, K], so the cached pairs are
(codes [N, K] int8, scales [N] f32): the transposes of the JAX package's
``quantize_cols`` of the [K, N] kernel. ``int8_matmul`` is left to a stock
op (``torch._int_mm``), as the JAX package leaves it to XLA outside any
Pallas kernel.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F


def quantize_rows(x: torch.Tensor):
    """Symmetric per-row int8: [.., K] -> (int8 codes, [.., 1] f32 scales).
    The divisor 127 is a full tensor: PyTorch's CUDA division by a scalar
    multiplies by its reciprocal, which rounds differently."""
    xf = x.float()
    amax = xf.abs().amax(dim=-1, keepdim=True)
    scale = torch.clamp(amax, min=1e-8) / torch.full_like(amax, 127.0)
    q = torch.clamp(torch.round(xf / scale), -127, 127).to(torch.int8)
    return q, scale


def quantize_cols(w: torch.Tensor):
    """Symmetric per-output-channel int8 of a JAX-layout kernel: [K, N] ->
    (int8 [K, N], [N] f32 scales)."""
    q, scale = quantize_rows(w.t())
    return q.t(), scale[:, 0]


def as_quantized_cols(w):
    """A weight argument in nn.Linear layout -> its (codes [N, K], scales
    [N]) pair: a pair (from the load-time cache) passes through, a raw
    [N, K] weight is quantized per output channel."""
    if isinstance(w, (tuple, list)):
        wq, ws = w
        return wq, ws
    q, scale = quantize_rows(w)
    return q, scale[:, 0]


def int_mm(a: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """Exact int32 a [M, K] @ w[N, K]^T of int8 operands through
    ``torch._int_mm``. On CUDA it takes more than 16 rows, K and N multiples
    of 8, and both operands K-contiguous (cuBLASLt's int8 "TN" layout), so
    the operands are zero-padded to that (exact), w goes in as the
    transposed view of its rows, and the result is cut back."""
    M, K = a.shape
    N = w.shape[0]
    pm, pk, pn = max(17 - M, 0), -K % 8, -N % 8
    if pm or pk:
        a = F.pad(a, (0, pk, 0, pm))
    if pn or pk:
        w = F.pad(w, (0, pk, 0, pn))
    return torch._int_mm(a.contiguous(), w.contiguous().t())[:M, :N]


def int8_matmul(x: torch.Tensor, w, bias: torch.Tensor | None = None,
                out_dtype: torch.dtype | None = None) -> torch.Tensor:
    """x [.., K] @ w^T via dynamic W8A8 with exact int32 accumulation:
    ``f32(acc) * xs * ws + bias`` cast to `out_dtype` (x.dtype by default).
    `w` is an nn.Linear weight [N, K] or its cached (codes, scales) pair."""
    out_dtype = out_dtype or x.dtype
    xq, xs = quantize_rows(x)
    wq, ws = as_quantized_cols(w)
    lead = x.shape[:-1]
    acc = int_mm(xq.reshape(-1, x.shape[-1]), wq).reshape(*lead, wq.shape[0])
    y = acc.float() * xs * ws
    if bias is not None:
        y = y + bias.float()
    return y.to(out_dtype)
