"""Waveform conv0 + LayerNorm + GELU: port of the Pallas kernel
`conv0_ln_gelu` (s3prl_tpu/kernels/conv_frontend.py:136), erf mode.

The first layer of the wav2vec2/HuBERT extractor (C_in=1, k=10, s=5, 512
channels, no bias) writes the pipeline's largest tensor; the CUDA kernel
(`csrc/conv0_ln_gelu.cu`) computes conv -> f32 LN -> GELU in one pass and
writes it once. The tanh-GELU mode of the int8 path is not ported yet.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

from ._build import launch
from ._common import on_cpu, require, stream_of


def conv0_ln_gelu_reference(wavs: torch.Tensor, weight: torch.Tensor,
                            scale: torch.Tensor, bias: torch.Tensor,
                            stride: int = 5, k: int = 10) -> torch.Tensor:
    """Plain version. wavs [B, T] in the model dtype, weight [C, 1, k]
    (nn.Conv1d layout) -> GELU(LN(conv1d(wavs)))[B, (T-k)//stride+1, C] in
    wavs.dtype. Cast points as the Pallas kernel: the weight is cast to the
    wav dtype, the dot accumulates in f32 (products of bf16 values are exact
    in f32), LN and GELU run in f32, one cast at the end."""
    w = weight.to(wavs.dtype).float()[:, 0, :]  # [C, k]
    frames = wavs.float().unfold(1, k, stride)  # [B, T_out, k]
    y = frames @ w.t()
    y = F.layer_norm(y, (y.shape[-1],), scale.float(), bias.float(), eps=1e-5)
    return F.gelu(y).to(wavs.dtype)


def conv0_ln_gelu(wavs: torch.Tensor, weight: torch.Tensor, scale: torch.Tensor,
                  bias: torch.Tensor, stride: int = 5, k: int = 10) -> torch.Tensor:
    """wavs [B, T] (bf16 or f32) -> GELU(LN(conv1d(wavs)))[B, (T-k)//stride+1, C].

    weight [C, 1, k] in wavs.dtype (nn.Conv1d layout, the transpose of the
    JAX kernel's [k, 1, C]), scale/bias [C] f32 (nn.LayerNorm). CPU tensors
    run the plain version; CUDA tensors launch the kernel, which takes
    C=512, k=10, stride=5."""
    if on_cpu(wavs, weight, scale, bias):
        return conv0_ln_gelu_reference(wavs, weight, scale, bias, stride, k)
    if wavs.dtype not in (torch.bfloat16, torch.float32):
        raise TypeError(f"conv0_ln_gelu: wav dtype {wavs.dtype}, the kernel takes bf16 or f32")
    if (stride, k) != (5, 10):
        raise ValueError(
            f"conv0_ln_gelu: the kernel takes k=10, stride=5, got k={k}, stride={stride}")
    B, T = wavs.shape
    require(wavs, "wavs", wavs.dtype)
    require(weight, "weight", wavs.dtype, (512, 1, k))
    require(scale, "scale", torch.float32, (512,))
    require(bias, "bias", torch.float32, (512,))
    if T < k:
        raise ValueError(f"conv0_ln_gelu: {T} samples, fewer than the kernel width {k}")
    n_frames = (T - k) // stride + 1
    out = torch.empty(B, n_frames, 512, dtype=wavs.dtype, device=wavs.device)
    if B:
        with torch.cuda.device(wavs.device):
            launch("s3_conv0_ln_gelu", wavs.data_ptr(), weight.data_ptr(),
                   scale.data_ptr(), bias.data_ptr(), out.data_ptr(), B, T,
                   n_frames, int(wavs.dtype == torch.bfloat16), stream_of(wavs))
        conv0_ln_gelu.launches += 1
    return out


conv0_ln_gelu.launches = 0  # CUDA launches since the last reset
