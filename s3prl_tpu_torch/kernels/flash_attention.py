"""Whole pre-/post-LN attention blocks: ports of the Pallas kernels
`fused_attention_block` (int8 W8A8, K1, s3prl_tpu/kernels/flash_attention.py:
664) and `fused_attention_block_bf16` (K4, :797).

K4, bf16:

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

K1, int8 (the serving default), the same four steps on int8 GEMMs with
the Pallas kernel's dynamic per-row scales and cast points:

1. `csrc/quant_rows.cu`: [LN(x) in f32 ->] per-row int8 codes and scales;
2. `csrc/gemm_s8.cu`: QKV = bf16(bf16(bf16(acc) * bf16(s_x * ws)) + bf16(bq))
   [B*T, 3C] (flash_attention.py:537-544);
3. `csrc/attention.cu` (K1's default attention math is K4's, :564-588);
4. `csrc/quant_rows.cu`: the context's per-row codes in bf16 (:605-611),
   then `csrc/gemm_s8.cu`: f32(acc) * s_a * wos + bo + x (:612-617); with
   ``postnorm`` the sum stays f32 and `csrc/layernorm.cu` writes LN(sum).

Parity is held at each function's boundary. Sequences beyond MAX_BLOCK_T
frames are the long-utterance kernels' (K6 for int8, K7/K8 for bf16; not
ported yet); the encoder layer refuses them before calling here.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

from ..ops.quant import as_quantized_cols, int_mm, quantize_rows
from ._build import launch
from ._common import (GEMM_LINEAR, GEMM_QKV, gemm, gemm_s8, layer_norm,
                      layer_norm_f32, on_cpu, quant_rows, quant_rows_bf16,
                      require, stream_of)

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


def quantize_context_reference(attn: torch.Tensor):
    """K1's per-row context quantization, in bf16 (flash_attention.py:
    605-611): s_a = bf16(max(absmax, bf16(1e-6)) / bf16(127)), codes
    clip(round(f32(bf16(attn / s_a)))). attn [.., C] bf16 -> (int8, f32
    [.., 1] holding the bf16 scales)."""
    amax = attn.abs().amax(dim=-1, keepdim=True)
    s_a = torch.maximum(amax, torch.full_like(amax, 1e-6)) / torch.full_like(amax, 127.0)
    q = torch.clamp(torch.round((attn / s_a).float()), -127, 127).to(torch.int8)
    return q, s_a.float()


def fused_attention_block_reference(x, wq, bq, ln, wo, bo, kv_lens, num_heads: int,
                                    postnorm: bool = False):
    """Plain version of K1 with the Pallas kernel's cast points: [LN in
    f32 ->] f32 per-row quantization, exact int32 QKV sums dequantized as
    bf16(bf16(bf16(acc) * bf16(s_x * ws)) + bf16(bq)), K4's attention,
    bf16 context quantization, f32(acc) * s_a * wos + bo + x in f32, [LN],
    one cast to x.dtype. wq, wo: nn.Linear weights or (codes, scales)."""
    B, T, C = x.shape
    bf = torch.bfloat16
    wq_q, wq_s = as_quantized_cols(wq)
    wo_q, wo_s = as_quantized_cols(wo)
    x_in = x.float().reshape(B * T, C)
    xn = x_in if postnorm else layer_norm_f32(x_in, ln)
    x8, s_x = quantize_rows(xn)
    qkv = int_mm(x8, wq_q).to(bf) * (s_x * wq_s).to(bf) + bq.to(bf)
    attn = attention_reference(qkv.view(B, T, 3 * C), kv_lens, num_heads).view(B * T, C)
    a8, s_a = quantize_context_reference(attn)
    y = int_mm(a8, wo_q).float() * s_a * wo_s + bo.float() + x_in
    if postnorm:
        y = layer_norm_f32(y, ln)
    return y.to(x.dtype).view(B, T, C)


def fused_attention_block(x, wq, bq, ln, wo, bo, kv_lens, num_heads: int,
                          act_scales=None, postnorm: bool = False):
    """x + out_proj(MHA(qkv_proj(LN(x)))) with int8 W8A8 projections, or
    with ``postnorm`` LN(x + out_proj(MHA(qkv_proj(x)))), in bf16: K1.

    The argument order is the JAX function's. x [B, T, C] bf16; wq, wo the
    cached (codes [3C, C] / [C, C] int8, scales [3C] / [C] f32) pairs in
    nn.Linear layout (a raw weight is quantized here); bq [3C], bo [C] and
    ln = (scale, bias) f32; kv_lens [B] int32. Dynamic per-row activation
    scales; the static ones (`act_scales`) are not ported and raise. CPU
    tensors run the plain version; CUDA tensors launch the kernels, which
    take head dim 64 and T <= MAX_BLOCK_T."""
    if act_scales is not None:
        raise NotImplementedError(
            "K1 fused_attention_block with static activation scales (act_scales, "
            "the static_q option) is not ported yet (ROADMAP.md Queue 2, K1)")
    wq_q, wq_s = as_quantized_cols(wq)
    wo_q, wo_s = as_quantized_cols(wo)
    tensors = (x, wq_q, wq_s, bq, ln[0], ln[1], wo_q, wo_s, bo, kv_lens)
    if on_cpu(*tensors):
        return fused_attention_block_reference(
            x, (wq_q, wq_s), bq, ln, (wo_q, wo_s), bo, kv_lens, num_heads, postnorm)
    B, T, C = x.shape
    if C != num_heads * HEAD_DIM:
        raise ValueError(f"attention kernel takes head dim {HEAD_DIM}, got C={C}, H={num_heads}")
    if T > MAX_BLOCK_T:
        raise ValueError(f"attention block kernel takes T <= {MAX_BLOCK_T}, got {T}")
    require(x, "x", torch.bfloat16)
    require(kv_lens, "kv_lens", torch.int32, (B,))
    require(wq_q, "wq codes", torch.int8, (3 * C, C))
    require(wo_q, "wo codes", torch.int8, (C, C))
    with torch.cuda.device(x.device):
        x2 = x.view(B * T, C)
        x8, s_x = quant_rows(x2, ln=None if postnorm else ln)
        qkv = gemm_s8(x8, wq_q, mode=GEMM_QKV, row_scale=s_x, col_scale=wq_s, bias=bq)
        attn = torch.empty(B * T, C, dtype=torch.bfloat16, device=x.device)
        if B * T:
            launch("s3_attention", qkv.data_ptr(), kv_lens.data_ptr(),
                   attn.data_ptr(), B, T, num_heads, HEAD_DIM ** -0.5,
                   stream_of(x))
        a8, s_a = quant_rows_bf16(attn)
        y = gemm_s8(a8, wo_q, mode=GEMM_LINEAR, row_scale=s_a, col_scale=wo_s, bias=bo,
                    residual=x2, out_f32=postnorm)
        if postnorm:
            y = layer_norm(y, ln[0], ln[1])
    fused_attention_block.launches += 1
    return y.view(B, T, C)


fused_attention_block.launches = 0  # CUDA launches since the last reset
