"""Whole pre-/post-LN attention block in bf16: port of the Pallas kernel
`fused_attention_block_bf16` (s3prl_tpu/kernels/flash_attention.py:797).

The TPU kernel runs LN -> QKV GEMM -> masked MHA -> out-proj + bias +
residual for one utterance in one VMEM-resident cell. An H100 SM holds 227
KB of shared memory, not the 3 MB [T, 3C] QKV tile of a 10 s utterance, so
the port is four launches behind one function, with the intermediates in
device memory (fusing them is later work):

1. `csrc/layernorm.cu`: LN(x) in f32 -> bf16 (pre-LN only);
2. `csrc/gemm_bf16.cu`: QKV = xn @ Wqkv^T + bq -> bf16 [B*T, 3C];
3. `csrc/attention.cu`: per-head masked softmax attention from the fused
   QKV buffer -> bf16 [B*T, C];
4. `csrc/gemm_bf16.cu`: out-proj + bo + x; with ``postnorm`` the sum stays
   f32 and `csrc/layernorm.cu` writes LN(sum) in bf16.

Parity is held at this function's boundary. Sequences beyond MAX_BLOCK_T
frames are the long-utterance kernels' (K7/K8, not ported yet); the encoder
layer refuses them before calling here.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

from ._build import launch
from ._common import gemm, layer_norm, on_cpu, require, stream_of

MAX_BLOCK_T = 512  # whole-block cells serve T <= 512 (TPU VMEM bound, kept as the routing rule)
HEAD_DIM = 64  # the attention kernel's head width


def _layer_norm_f32(x: torch.Tensor, ln) -> torch.Tensor:
    return F.layer_norm(x, (x.shape[-1],), ln[0].float(), ln[1].float(), eps=1e-5)


def attention_reference(qkv: torch.Tensor, kv_lens: torch.Tensor,
                        num_heads: int) -> torch.Tensor:
    """Plain masked MHA from the fused qkv [B, T, 3C] (bf16 values): f32
    scores scaled by Dh^-0.5 plus the additive -1e9 key mask, f32 softmax,
    bf16 P.V with f32 accumulation, bf16 out [B, T, C]."""
    B, T, C3 = qkv.shape
    C = C3 // 3
    Dh = C // num_heads
    q, k, v = qkv.float().view(B, T, 3, num_heads, Dh).permute(2, 0, 3, 1, 4)
    scores = (q @ k.transpose(-1, -2)) * Dh ** -0.5
    col = torch.arange(T, device=qkv.device)
    penalty = torch.where(col[None, :] < kv_lens[:, None].to(col.dtype), 0.0, -1e9)
    p = torch.softmax(scores + penalty[:, None, None, :], dim=-1)
    ctx = p.to(torch.bfloat16).float() @ v  # [B, H, T, Dh]
    return ctx.transpose(1, 2).reshape(B, T, C).to(torch.bfloat16)


def fused_attention_block_bf16_reference(x, wq, bq, ln, wo, bo, kv_lens,
                                         num_heads: int, postnorm: bool = False):
    """Plain version with the Pallas kernel's cast points: LN in f32, bf16
    GEMM operands with f32 accumulation, QKV rounded to bf16 after its bias,
    per-head context rounded to bf16, out-proj + bias + x in f32, [LN], one
    cast to x.dtype at the end."""
    B, T, C = x.shape
    x_in = x.float()
    xn = x_in if postnorm else _layer_norm_f32(x_in, ln)
    qkv = (xn.to(torch.bfloat16).float() @ wq.to(torch.bfloat16).float().t()
           + bq.float()).to(torch.bfloat16)
    attn = attention_reference(qkv, kv_lens, num_heads)
    y = attn.float() @ wo.to(torch.bfloat16).float().t() + bo.float() + x_in
    if postnorm:
        y = _layer_norm_f32(y, ln)
    return y.to(x.dtype)


def fused_attention_block_bf16(x, wq, bq, ln, wo, bo, kv_lens, num_heads: int,
                               postnorm: bool = False):
    """x + out_proj(MHA(qkv_proj(LN(x)))), or with ``postnorm``
    LN(x + out_proj(MHA(qkv_proj(x)))), in bf16.

    x [B, T, C] bf16; wq [3C, C] and wo [C, C] bf16 in nn.Linear layout (the
    transposes of the JAX kernel's [C, 3C] and [C, C]); bq [3C], bo [C] and
    ln = (scale [C], bias [C]) f32; kv_lens [B] int32 valid keys per
    utterance. CPU tensors run the plain version; CUDA tensors launch the
    kernels, which take head dim 64 and T <= MAX_BLOCK_T."""
    tensors = (x, wq, bq, ln[0], ln[1], wo, bo, kv_lens)
    if on_cpu(*tensors):
        return fused_attention_block_bf16_reference(
            x, wq, bq, ln, wo, bo, kv_lens, num_heads, postnorm)
    B, T, C = x.shape
    if C != num_heads * HEAD_DIM:
        raise ValueError(f"attention kernel takes head dim {HEAD_DIM}, got C={C}, H={num_heads}")
    if T > MAX_BLOCK_T:
        raise ValueError(f"attention block kernel takes T <= {MAX_BLOCK_T}, got {T}")
    require(x, "x", torch.bfloat16)
    require(kv_lens, "kv_lens", torch.int32, (B,))
    with torch.cuda.device(x.device):
        x2 = x.view(B * T, C)
        h = x2 if postnorm else layer_norm(x2, ln[0], ln[1])
        qkv = gemm(h, wq, bq)
        attn = torch.empty(B * T, C, dtype=torch.bfloat16, device=x.device)
        if B * T:
            launch("s3_attention", qkv.data_ptr(), kv_lens.data_ptr(),
                   attn.data_ptr(), B, T, num_heads, HEAD_DIM ** -0.5,
                   stream_of(x))
        y = gemm(attn, wo, bo, residual=x2, out_f32=postnorm)
        if postnorm:
            y = layer_norm(y, ln[0], ln[1])
    fused_attention_block_bf16.launches += 1
    return y.view(B, T, C)


fused_attention_block_bf16.launches = 0  # CUDA launches since the last reset
