"""Row LayerNorm + GELU: port of the Pallas kernel `ln_gelu` (K15,
s3prl_tpu/kernels/ln_gelu.py:47, pallas_call at :60).

The ``fused_midln`` option of the conv front end runs it after each stock
mid conv in place of the f32 LayerNorm, the cast and the GELU: one read and
one write of [B, T_i, 512] per layer. `csrc/ln_gelu.cu` keeps each row in
one warp's registers (f32 statistics, eps 1e-5) and casts once at the end,
after the GELU. That differs from the stock mid layer, which rounds the LN
output to the model dtype before its GELU (s3prl_tpu/models/convfe.py:338,
:344); the plain version follows the kernel.
"""

from __future__ import annotations

import torch

from ._common import ln_gelu_f32, ln_gelu_rows, on_cpu, refuse_grad
from .conv_frontend import GELU_MODES


def ln_gelu_reference(x: torch.Tensor, scale: torch.Tensor, bias: torch.Tensor,
                      gelu_mode: str = "erf") -> torch.Tensor:
    """Plain version: LN and GELU (erf or tanh) in f32, one cast to x.dtype."""
    return ln_gelu_f32(x, scale, bias, gelu_mode).to(x.dtype)


def ln_gelu(x: torch.Tensor, scale: torch.Tensor, bias: torch.Tensor,
            gelu_mode: str = "erf") -> torch.Tensor:
    """GELU(LayerNorm(x)) over the last axis of x [..., C] in x.dtype: K15.

    scale/bias [C] f32 (nn.LayerNorm); GELU exact ("erf") or tanh-approximate
    ("tanh", int8 serving). CPU tensors run the plain version; CUDA tensors
    launch `csrc/ln_gelu.cu`, which takes bf16 or f32 x, contiguous, with C
    = 512. Forward-only."""
    if gelu_mode not in GELU_MODES:
        raise ValueError(f"ln_gelu: gelu_mode {gelu_mode!r}, one of {GELU_MODES}")
    if on_cpu(x, scale, bias):
        return ln_gelu_reference(x, scale, bias, gelu_mode)
    if x.shape[-1] != 512:
        raise ValueError(f"ln_gelu: {x.shape[-1]} channels, the kernel takes 512")
    if not x.is_contiguous():
        raise ValueError("ln_gelu x: the kernel takes contiguous tensors")
    refuse_grad("K15 ln_gelu", x, scale, bias)
    rows = x.numel() // 512
    if not rows:
        return torch.empty_like(x)
    with torch.cuda.device(x.device):
        out = ln_gelu_rows(x.view(rows, 512), scale, bias, gelu_mode)
    ln_gelu.launches += 1
    return out.view(x.shape)


ln_gelu.launches = 0  # CUDA launches since the last reset
