"""Dispatch rule and the launches shared by the block kernels.

Every kernel wrapper of the port follows one rule: tensors on the CPU go to
the kernel's plain PyTorch version; CUDA tensors go to the CUDA kernel, or
the wrapper raises. There is no fallback after a failed launch and no switch.

`layer_norm` and `gemm` launch the row-LN and GEMM kernels that the
attention-block and FFN-block wrappers are built from; they check what the
kernels take and raise on anything else.
"""

from __future__ import annotations

import torch

from ._build import launch


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


def gemm(a: torch.Tensor, w: torch.Tensor, bias: torch.Tensor,
         residual: torch.Tensor | None = None, gelu: bool = False,
         out_f32: bool = False) -> torch.Tensor:
    """a [M, K] bf16 @ w[N, K]^T (nn.Linear layout) + bias f32 [N]
    [-> erf GELU] [+ residual bf16 [M, N]] -> bf16 (or f32) [M, N], f32
    accumulation (CUDA only)."""
    M, K = a.shape
    N = w.shape[0]
    require(a, "gemm a", torch.bfloat16)
    require(w, "gemm w", torch.bfloat16, (N, K))
    require(bias, "gemm bias", torch.float32, (N,))
    if residual is not None:
        require(residual, "gemm residual", torch.bfloat16, (M, N))
    if K % 8 or N % 8:
        raise ValueError(f"gemm: K={K} and N={N} must be multiples of 8")
    out = torch.empty(M, N, dtype=torch.float32 if out_f32 else torch.bfloat16,
                      device=a.device)
    if M:
        launch("s3_gemm_bf16", a.data_ptr(), w.data_ptr(), bias.data_ptr(),
               residual.data_ptr() if residual is not None else None,
               out.data_ptr(), int(out_f32), int(gelu), M, N, K, stream_of(a))
    return out
