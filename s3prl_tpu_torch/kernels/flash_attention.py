"""Attention kernels of the port: the whole pre-/post-LN attention blocks,
ports of the Pallas kernels `fused_attention_block` (int8 W8A8, K1,
s3prl_tpu/kernels/flash_attention.py:664) and `fused_attention_block_bf16`
(K4, :797), and the long-utterance attention (K6, K7, K8, below).

K4, bf16:

The TPU kernel runs LN -> QKV GEMM -> masked MHA -> out-proj + bias +
residual for one utterance in one VMEM-resident cell. An H100 SM holds 227
KB of shared memory, not the 3 MB [T, 3C] QKV tile of a 10 s utterance, so
the port is four launches behind one function, with the intermediates in
device memory (fusing them is later work):

1. `csrc/layernorm.cu`: LN(x) in f32 -> bf16 (pre-LN only);
2. `csrc/gemm_bf16.cu`: QKV = xn @ Wqkv^T + bq -> bf16 [B*T, 3C];
3. `csrc/gated_attention.cu`, its packed instantiation (`_attention`):
   per-head masked softmax attention read by TMA from the fused QKV
   buffer -> bf16 [B*T, C];
4. `csrc/gemm_bf16.cu`: out-proj + bo + x; with ``postnorm`` the sum stays
   f32 and `csrc/layernorm.cu` writes LN(sum) in bf16.

K1, int8 (the serving default), three launches with the Pallas kernel's
dynamic per-row scales and cast points, its two projections on the int8
panel kernel (`csrc/int8_panel.cu`, `int8_projection`), which keeps 128
whole rows on chip and quantizes them there, as the Pallas cell does:

1. `csrc/int8_panel.cu`: [LN(x) in f32 ->] per-row int8 codes and scales,
   QKV = bf16(bf16(bf16(acc) * bf16(s_x * ws)) + bf16(bq)) [B*T, 3C]
   (flash_attention.py:512-544);
2. `csrc/gated_attention.cu` packed (K1's default attention math is K4's,
   :564-588);
3. `csrc/int8_panel.cu`: the context's per-row codes in bf16 (:605-611),
   f32(acc) * s_a * wos + bo + x (:612-617); with ``postnorm`` the sum
   stays f32 and `csrc/layernorm.cu` writes LN(sum).

Rows wider than PANEL_MAX_C take `csrc/quant_rows.cu` + `csrc/gemm_s8.cu`
for each projection.

Parity is held at each function's boundary. Sequences beyond MAX_BLOCK_T
frames go to the long-utterance kernels below; the encoder layer routes
them there.

The long-utterance kernels (512 < T; the JAX package's routing, threshold
for threshold, both read at call time):

- K7 `fused_qkv_attention` (flash_attention.py:232): masked MHA from the
  fused [B, T, 3C] QKV buffer, for T <= MAX_KERNEL_T one launch of the
  packed instantiation of `csrc/gated_attention.cu` (`_attention`, which
  has no T bound of its own);
- K6 `fused_qkv_attention_outproj` (:338), int8: the same with an f32
  context, then one `csrc/int8_panel.cu` launch on those f32 rows (f32
  per-row quantization on chip, clamp 1e-8; int8 out-proj, f32(acc) * s *
  wos + bo + x); rows wider than PANEL_MAX_C take `csrc/quant_rows.cu` +
  `csrc/gemm_s8.cu`;
- K8 `online_flash_attention` (:892): K-blocked online softmax in f32 on
  [B, H, T, 64], the no-bias instantiation of `csrc/gated_attention.cu`
  (K17's) with the mask -1e30 and the floor 1e-30. Beyond MAX_KERNEL_T
  frames K7 and K6 hand their attention to it (:241-249, :350-352).

WavLM's gated relative-position-bias attention (scores q.k^T + gate[b, h, t]
* pos_bias[h, t, s]), both on `csrc/gated_attention.cu` (wgmma, a ring of
TMA K/V and cp.async bias tiles); the bias comes in f32 at any row stride
or in bf16 with rows a multiple of 8 elements apart (the model's padded
[H, T, Tp] buffer, `WavLMEncoder._layer_args`):

- K9 `gated_bias_attention` (:139, whole-T cell :59-89): mask -1e9, no
  floor on the denominator; beyond MAX_KERNEL_T it hands over to
- K10 `gated_online_flash_attention`, the port of `_gated_online_flash_kernel`
  (:949, K-blocked cell :901-945): mask -1e30, denominator max(l, 1e-30).

K17 `flash_attention` (:1040, cell `_attn_kernel_nobias` :994-1011), masked
attention without a bias on split heads, is the no-bias instantiation of
the same source (mask -1e9, no floor); beyond MAX_KERNEL_T it hands over to
K8. No model calls it; its only caller in the JAX package is a test.

K11 `gated_bias_attention_outproj` (:454, cell :360-403), WavLM's opt-in
fused attention: K6's math (unscaled qkv, P normalised and cast before
P.V, the f32 context quantized per row, int8 out-proj + bo + residual) with
the gated bias added before the mask: the gated packed instantiation of
`csrc/gated_attention.cu` (f32 bias, f32 context), then K6's
`csrc/quant_rows.cu` and `csrc/gemm_s8.cu`; beyond MAX_KERNEL_T it hands
over to K9 -> K10 and stock ops (:466-477).
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

from ..ops.quant import as_quantized_cols, int8_matmul, int_mm, quantize_rows
from ._build import launch
from ._common import (GEMM_LINEAR, GEMM_QKV, RULE_CTX, gemm, gemm_s8, int8_panel_reference,
                      int8_projection, layer_norm, layer_norm_f32, on_cpu, quant_rows,
                      refuse_grad, require, stream_of)

MAX_BLOCK_T = 512  # whole-block cells serve T <= 512 (TPU VMEM bound, kept as the routing rule)
MAX_KERNEL_T = 2048  # K6/K7 serve T <= 2048, K8 beyond (the JAX package's routing rule)
HEAD_DIM = 64  # the attention kernels' head width
_LOG2E = 1.4426950408889634


def _layer_norm_f32(x: torch.Tensor, ln) -> torch.Tensor:
    return F.layer_norm(x, (x.shape[-1],), ln[0].float(), ln[1].float(), eps=1e-5)


def attention_reference(qkv: torch.Tensor, kv_lens: torch.Tensor, num_heads: int,
                        out_dtype: torch.dtype | None = None, bias=None) -> torch.Tensor:
    """Plain masked MHA from the fused qkv [B, T, 3C]: f32 scores scaled by
    Dh^-0.5 [plus gate * pos_bias, `bias` = (pos_bias [H, T, T], gate [B, H,
    T]): K11's cell] plus the additive -1e9 key mask, f32 softmax, P
    normalised and cast to qkv's dtype, P.V with f32 accumulation, heads
    concatenated, out [B, T, C] in `out_dtype` (qkv's dtype by default; f32
    keeps K6's and K11's unrounded context)."""
    B, T, C3 = qkv.shape
    C = C3 // 3
    Dh = C // num_heads
    q, k, v = qkv.float().view(B, T, 3, num_heads, Dh).permute(2, 0, 3, 1, 4)
    scores = (q @ k.transpose(-1, -2)) * Dh ** -0.5
    if bias is not None:
        pos_bias, gate = bias
        scores = scores + gate.float()[..., None] * pos_bias.float()[None]
    col = torch.arange(T, device=qkv.device)
    penalty = torch.where(col[None, :] < kv_lens[:, None].to(col.dtype), 0.0, -1e9)
    p = torch.softmax(scores + penalty[:, None, None, :], dim=-1)
    ctx = p.to(qkv.dtype).float() @ v  # [B, H, T, Dh]
    return ctx.transpose(1, 2).reshape(B, T, C).to(out_dtype or qkv.dtype)


def _attention(qkv: torch.Tensor, kv_lens: torch.Tensor, num_heads: int,
               out_f32: bool = False, bias=None) -> torch.Tensor:
    """One launch on qkv [B, T, 3C] bf16 (CUDA only) -> [B * T, C], bf16
    or f32: the packed instantiation of `csrc/gated_attention.cu` (K7's
    math, `attention_reference`'s; a row with kv_len = 0 attends to all T
    keys alike); with `bias` = (pos_bias [H, T, T], gate [B, H, T]), both
    f32, its gated packed instantiation (K11's; f32 out only). pos_bias
    may be a view with padded rows (`_bias_row_stride`): the model's rows of
    a multiple of 4 floats take 16-byte copies, other rows 4-byte ones."""
    B, T, C3 = qkv.shape
    C = C3 // 3
    if C != num_heads * HEAD_DIM:
        raise ValueError(f"attention kernel takes head dim {HEAD_DIM}, got C={C}, H={num_heads}")
    require(qkv, "qkv", torch.bfloat16)
    if qkv.data_ptr() % 16:
        raise ValueError("attention qkv: 16-byte aligned rows only")
    require(kv_lens, "kv_lens", torch.int32, (B,))
    if bias is not None:
        if not out_f32:
            raise ValueError("the gated attention kernel writes an f32 context only")
        if bias[0].dtype != torch.float32:
            raise TypeError(f"pos_bias: dtype {bias[0].dtype}, the gated packed kernel "
                            "takes f32")
        ld = _bias_row_stride(bias[0], num_heads, T)
        require(bias[1], "gate", torch.float32, (B, num_heads, T))
    out = torch.empty(B * T, C, dtype=torch.float32 if out_f32 else torch.bfloat16,
                      device=qkv.device)
    if not B * T:
        return out
    if bias is None:
        launch("s3_qkv_attention", qkv.data_ptr(), kv_lens.data_ptr(), out.data_ptr(), B, T,
               num_heads, HEAD_DIM ** -0.5, int(out_f32), stream_of(qkv))
    else:
        launch("s3_qkv_attention_gated", qkv.data_ptr(), kv_lens.data_ptr(),
               bias[0].data_ptr(), ld, bias[1].data_ptr(), out.data_ptr(), B, T, num_heads,
               HEAD_DIM ** -0.5, stream_of(qkv))
    return out


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
    if T > MAX_BLOCK_T:
        raise ValueError(f"attention block kernel takes T <= {MAX_BLOCK_T}, got {T}")
    require(x, "x", torch.bfloat16)
    refuse_grad("K4 fused_attention_block_bf16", *tensors)
    with torch.cuda.device(x.device):
        x2 = x.view(B * T, C)
        h = x2 if postnorm else layer_norm(x2, ln[0], ln[1])
        qkv = gemm(h, wq, bq)
        attn = _attention(qkv.view(B, T, 3 * C), kv_lens, num_heads)
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
    if T > MAX_BLOCK_T:
        raise ValueError(f"attention block kernel takes T <= {MAX_BLOCK_T}, got {T}")
    require(x, "x", torch.bfloat16)
    require(wq_q, "wq codes", torch.int8, (3 * C, C))
    require(wo_q, "wo codes", torch.int8, (C, C))
    refuse_grad("K1 fused_attention_block", *tensors)
    with torch.cuda.device(x.device):
        x2 = x.view(B * T, C)
        qkv = int8_projection(x2, wq_q, wq_s, bq, ln=None if postnorm else ln,
                              mode=GEMM_QKV)
        attn = _attention(qkv.view(B, T, 3 * C), kv_lens, num_heads)
        y = int8_projection(attn, wo_q, wo_s, bo, rule=RULE_CTX, residual=x2,
                            out_f32=postnorm)
        if postnorm:
            y = layer_norm(y, ln[0], ln[1])
    fused_attention_block.launches += 1
    return y.view(B, T, C)


fused_attention_block.launches = 0  # CUDA launches since the last reset


def online_flash_attention_reference(q, k, v, kv_lens):
    """Plain version of K8 with the Pallas cell's math (:830-854): q, k, v
    [B, H, T, Dh] cast to f32 (q pre-scaled), scores of keys at or past
    kv_len replaced by -1e30, p = exp2((s - max) * log2 e) kept in f32 for
    P.V, out = acc / max(sum p, 1e-30) in q's dtype: the no-bias gated
    math with K10's constants."""
    return _gated_reference(q, k, v, None, None, kv_lens, -1e30, 1e-30)


def online_flash_attention(q, k, v, kv_lens):
    """K-blocked online-softmax attention for sequences beyond MAX_KERNEL_T
    frames: K8. q, k, v [B, H, T, Dh] (q pre-scaled by Dh^-0.5), kv_lens
    [B] int32 valid keys (padding contiguous; a row with kv_len = 0 is the
    mean of the T values). CPU tensors run the plain version;
    CUDA tensors launch the no-bias instantiation of
    `csrc/gated_attention.cu` with the mask -1e30 and the floor 1e-30,
    which takes bf16 and head dim 64. Forward-only."""
    if on_cpu(q, k, v, kv_lens):
        return online_flash_attention_reference(q, k, v, kv_lens)
    out = _gated_launch(q, k, v, None, None, kv_lens, -1e30, 1e-30)
    online_flash_attention.launches += 1
    return out


online_flash_attention.launches = 0  # CUDA launches since the last reset


def fused_qkv_attention_reference(qkv, kv_lens, num_heads: int):
    """Plain version of K7 at T <= MAX_KERNEL_T (:159-197): K4's attention
    core, in qkv's dtype."""
    return attention_reference(qkv, kv_lens, num_heads)


def _split_heads(qkv: torch.Tensor, num_heads: int):
    """[B, T, 3C] -> q (times Dh^-0.5), k, v as contiguous [B, H, T, Dh]
    (:241-249). The scale is a scalar of qkv's dtype, as jnp's weakly typed
    float; 0.125 is exact in bf16 for Dh = 64."""
    B, T, C3 = qkv.shape
    Dh = C3 // 3 // num_heads
    q, k, v = qkv.view(B, T, 3, num_heads, Dh).permute(2, 0, 3, 1, 4)
    q = q * torch.tensor(Dh ** -0.5, dtype=qkv.dtype, device=qkv.device)
    return q.contiguous(), k.contiguous(), v.contiguous()


def fused_qkv_attention(qkv, kv_lens, num_heads: int):
    """Masked multi-head attention straight from the fused QKV buffer: K7.

    qkv [B, T, 3C] (unscaled), kv_lens [B] int32 valid keys (padding
    contiguous) -> [B, T, C] in qkv's dtype. Beyond MAX_KERNEL_T frames the
    heads are split out and K8 takes over (the JAX package's routing; its
    launch counts for K8, not here). CPU tensors run the plain versions;
    CUDA tensors launch the packed instantiation of `csrc/gated_attention.cu`
    (bf16 qkv, head dim 64). Forward-only."""
    cpu = on_cpu(qkv, kv_lens)
    if not cpu and qkv.dtype != torch.bfloat16:
        raise NotImplementedError(
            f"K7 fused_qkv_attention on the card takes bf16 qkv, got {qkv.dtype}: the "
            "f32 flash path is not ported yet (ROADMAP.md Queue 2, K7 with f32 qkv)")
    if not cpu:
        refuse_grad("K7 fused_qkv_attention", qkv)
    B, T, C3 = qkv.shape
    if T > MAX_KERNEL_T:
        out = online_flash_attention(*_split_heads(qkv, num_heads), kv_lens)
        return out.transpose(1, 2).reshape(B, T, C3 // 3)
    if cpu:
        return fused_qkv_attention_reference(qkv, kv_lens, num_heads)
    with torch.cuda.device(qkv.device):
        out = _attention(qkv, kv_lens, num_heads)
    fused_qkv_attention.launches += 1
    return out.view(B, T, C3 // 3)


fused_qkv_attention.launches = 0  # CUDA launches since the last reset


def fused_qkv_attention_outproj_reference(qkv, residual, wo, bo, kv_lens, num_heads: int):
    """Plain version of K6 at T <= MAX_KERNEL_T (:254-295): K7's attention
    with the heads concatenated in f32 (unrounded), f32 per-row
    quantization (max(absmax, 1e-8) / 127, round half to even), exact int32
    out-proj, ((f32(acc) * s) * wos + bo) + residual in f32, one cast to
    qkv's dtype. wo: an nn.Linear weight or its (codes, scales) pair."""
    ctx = attention_reference(qkv, kv_lens, num_heads, out_dtype=torch.float32)
    return _outproj_reference(ctx, residual, wo, bo, qkv.dtype)


def _outproj_reference(ctx, residual, wo, bo, dtype):
    """K6's and K11's tail on the f32 context [B, T, C], the panel's f32
    rule (`int8_panel_reference`): f32 per-row quantization, exact int32
    out-proj, ((f32(acc) * s) * wos + bo) + residual in f32, one cast to
    `dtype`."""
    B, T, C = ctx.shape
    wo_q, wo_s = as_quantized_cols(wo)
    y = int8_panel_reference(ctx.reshape(B * T, C), wo_q, wo_s, bo.float(),
                             residual=residual.reshape(B * T, C), out_f32=True)[0]
    return y.to(dtype).view(B, T, C)


def fused_qkv_attention_outproj(qkv, residual, wo, bo, kv_lens, num_heads: int):
    """residual + out_proj(MHA(qkv)) with the int8 W8A8 out-projection: K6.

    The argument order is the JAX function's. qkv [B, T, 3C] bf16 (the
    unscaled fused projection), residual [B, T, C] bf16 (the pre-attention
    x), wo the cached (codes [C, C] int8, scales [C] f32) pair in nn.Linear
    layout (a raw weight is quantized here), bo [C] f32, kv_lens [B] int32.
    Beyond MAX_KERNEL_T frames: residual + int8_matmul(K7 -> K8, wo, bo)
    (:350-352; its launches count for K8). CPU tensors run the plain
    versions; CUDA tensors launch the packed instantiation of
    `csrc/gated_attention.cu` (f32 context) and `int8_projection` on it:
    one `csrc/int8_panel.cu` launch (its f32 rule on f32 rows) up to
    PANEL_MAX_C, `csrc/quant_rows.cu` + `csrc/gemm_s8.cu` beyond (head dim
    64). Forward-only."""
    wo_q, wo_s = as_quantized_cols(wo)
    B, T, C3 = qkv.shape
    C = C3 // 3
    cpu = on_cpu(qkv, residual, wo_q, wo_s, bo, kv_lens)
    if not cpu:
        refuse_grad("K6 fused_qkv_attention_outproj", qkv, residual, wo_s, bo)
    if T > MAX_KERNEL_T:
        out = fused_qkv_attention(qkv, kv_lens, num_heads)
        return residual + int8_matmul(out, (wo_q, wo_s), bo, out_dtype=residual.dtype)
    if cpu:
        return fused_qkv_attention_outproj_reference(
            qkv, residual, (wo_q, wo_s), bo, kv_lens, num_heads)
    require(residual, "residual", torch.bfloat16, (B, T, C))
    require(wo_q, "wo codes", torch.int8, (C, C))
    with torch.cuda.device(qkv.device):
        ctx = _attention(qkv, kv_lens, num_heads, out_f32=True)
        # K6's f32 quantizer (:287-289), not K1's bf16 one, and its epilogue
        # order ((f32(acc) * s) * wos + bo) + residual in f32 (:294)
        y = int8_projection(ctx, wo_q, wo_s, bo, residual=residual.view(B * T, C))
    fused_qkv_attention_outproj.launches += 1
    return y.view(B, T, C)


fused_qkv_attention_outproj.launches = 0  # CUDA launches since the last reset


def _gated_reference(q, k, v, pos_bias, gate, kv_lens, masked: float, floor: float | None):
    """The gated cells' math in f32: s = q.k^T [+ gate * pos_bias (product,
    then sum); no bias when pos_bias is None], keys at or past kv_len set to
    `masked`, p = exp2((s - max) * log2 e) kept in f32 for P.V, out = (p.V) /
    sum p [floored] in q's dtype."""
    T = q.shape[2]
    s = q.float() @ k.float().transpose(-1, -2)
    if pos_bias is not None:
        s = s + gate.float()[..., None] * pos_bias.float()[None]
    col = torch.arange(T, device=q.device)
    valid = col[None, :] < kv_lens[:, None].to(col.dtype)  # [B, T keys]
    s = torch.where(valid[:, None, None, :], s, torch.full_like(s, masked))
    p = torch.exp2((s - s.amax(-1, keepdim=True)) * _LOG2E)
    denom = p.sum(-1, keepdim=True)
    if floor is not None:
        denom = torch.clamp(denom, min=floor)
    return ((p @ v.float()) / denom).to(q.dtype)


def gated_bias_attention_reference(q, k, v, pos_bias, gate, kv_lens):
    """Plain version of K9, the Pallas cell `_attn_kernel` (:71-89): q, k, v
    cast to f32, s = q k^T + gate[..., None] * pos_bias, keys at or past
    kv_len -> -1e9, p = exp2((s - max) * log2 e) in f32, out = (p @ v) /
    sum p in q's dtype."""
    return _gated_reference(q, k, v, pos_bias, gate, kv_lens, -1e9, None)


def gated_online_flash_attention_reference(q, k, v, pos_bias, gate, kv_lens):
    """Plain version of K10, the Pallas cell `_gated_online_kernel`
    (:919-945), over the whole row: K9's math with the mask -1e30 and the
    denominator max(sum p, 1e-30)."""
    return _gated_reference(q, k, v, pos_bias, gate, kv_lens, -1e30, 1e-30)


def _bias_row_stride(pos_bias, H: int, T: int) -> int:
    """The row stride in elements of a pos_bias [H, T, T] that
    `csrc/gated_attention.cu` takes, or raises: f32 at any row stride, bf16
    with rows a multiple of 8 elements apart from a 16-byte boundary (so
    that 16-byte copies reach every row); the last axis contiguous, the
    heads T rows apart."""
    if pos_bias.dtype not in (torch.float32, torch.bfloat16):
        raise TypeError(f"pos_bias: dtype {pos_bias.dtype}, the kernel takes f32 or bf16")
    if tuple(pos_bias.shape) != (H, T, T):
        raise ValueError(f"pos_bias: shape {tuple(pos_bias.shape)}, expected {(H, T, T)}")
    ld = pos_bias.stride(1)
    if pos_bias.stride(2) != 1 or ld < T or pos_bias.stride(0) != T * ld:
        raise ValueError(f"pos_bias: strides {pos_bias.stride()}, the kernel takes rows of "
                         "contiguous keys, the heads T rows apart")
    if pos_bias.dtype == torch.bfloat16 and (ld % 8 or pos_bias.data_ptr() % 16):
        raise ValueError(f"bf16 pos_bias: row stride {ld}, the kernel takes rows a multiple "
                         "of 8 elements apart from a 16-byte boundary")
    return ld


def _gated_launch(q, k, v, pos_bias, gate, kv_lens, masked: float, floor: float):
    """One launch of `csrc/gated_attention.cu` on split heads (CUDA only):
    checks what the kernel takes and raises on anything else. Without
    pos_bias (and gate) its no-bias instantiation: K17's entry (the -1e9
    mask, no floor) or, with a floor, K8's (the -1e30 mask, the floor
    1e-30)."""
    B, H, T, Dh = q.shape
    if Dh != HEAD_DIM:
        raise ValueError(f"gated attention kernel takes head dim {HEAD_DIM}, got {Dh}")
    for t, name in ((q, "q"), (k, "k"), (v, "v")):
        require(t, name, torch.bfloat16, (B, H, T, Dh))
        if t.data_ptr() % 16:
            raise ValueError(f"gated attention {name}: 16-byte aligned rows only")
    require(kv_lens, "kv_lens", torch.int32, (B,))
    if pos_bias is not None:
        ld = _bias_row_stride(pos_bias, H, T)
        require(gate, "gate", torch.float32, (B, H, T))
    refuse_grad("K8/K9/K10/K17 attention", q, k, v, pos_bias, gate)
    out = torch.empty_like(q)
    if B * H * T:
        with torch.cuda.device(q.device):
            if pos_bias is None:
                launch("s3_online_attention" if floor else "s3_flash_attention", q.data_ptr(),
                       k.data_ptr(), v.data_ptr(), kv_lens.data_ptr(), out.data_ptr(), B, H, T,
                       stream_of(q))
            else:
                launch("s3_gated_attention", q.data_ptr(), k.data_ptr(), v.data_ptr(),
                       pos_bias.data_ptr(), int(pos_bias.dtype == torch.float32), ld,
                       gate.data_ptr(), kv_lens.data_ptr(), out.data_ptr(), B, H, T, masked,
                       floor, stream_of(q))
    return out


def gated_online_flash_attention(q, k, v, pos_bias, gate, kv_lens):
    """K-blocked gated-bias attention for sequences beyond MAX_KERNEL_T
    frames: K10, the port of `_gated_online_flash_kernel`. Arguments as
    `gated_bias_attention`. CPU tensors run the plain version; CUDA tensors
    launch `csrc/gated_attention.cu` with the mask -1e30 and the floor
    1e-30. Forward-only."""
    if on_cpu(q, k, v, pos_bias, gate, kv_lens):
        return gated_online_flash_attention_reference(q, k, v, pos_bias, gate, kv_lens)
    out = _gated_launch(q, k, v, pos_bias, gate, kv_lens, -1e30, 1e-30)
    gated_online_flash_attention.launches += 1
    return out


gated_online_flash_attention.launches = 0  # CUDA launches since the last reset


def gated_bias_attention(q, k, v, pos_bias, gate, kv_lens):
    """Attention with WavLM's gated relative-position bias: K9.

    softmax(q k^T + gate[b, h, t] * pos_bias[h, t, s], keys at or past
    kv_len masked) v. q, k, v [B, H, T, Dh] (q pre-scaled by Dh^-0.5),
    pos_bias [H, T, T] (shared by the utterances; f32, or bf16 with rows a
    multiple of 8 elements apart, `_bias_row_stride`), gate [B, H, T] f32,
    kv_lens [B] int32 valid keys (padding contiguous; a row with kv_len =
    0 is the mean of the T values) -> [B, H, T, Dh] in q's
    dtype. Beyond MAX_KERNEL_T frames (read at call time) K10 takes over
    (:153-156; its launch counts for K10, not here). CPU tensors run the
    plain version; CUDA tensors launch `csrc/gated_attention.cu` (bf16 q,
    k, v, head dim 64). Forward-only."""
    if q.shape[2] > MAX_KERNEL_T:
        return gated_online_flash_attention(q, k, v, pos_bias, gate, kv_lens)
    if on_cpu(q, k, v, pos_bias, gate, kv_lens):
        return gated_bias_attention_reference(q, k, v, pos_bias, gate, kv_lens)
    out = _gated_launch(q, k, v, pos_bias, gate, kv_lens, -1e9, 0.0)
    gated_bias_attention.launches += 1
    return out


gated_bias_attention.launches = 0  # CUDA launches since the last reset


def flash_attention_reference(q, k, v, kv_lens):
    """Plain version of K17, the Pallas cell `_attn_kernel_nobias` (:994-1011):
    q, k, v cast to f32, s = q k^T, keys at or past kv_len -> -1e9, p =
    exp2((s - max) * log2 e) in f32, out = (p @ v) / sum p (no floor) in q's
    dtype."""
    return _gated_reference(q, k, v, None, None, kv_lens, -1e9, None)


def flash_attention(q, k, v, kv_lens):
    """Masked multi-head attention without a bias on split heads: K17.

    q (pre-scaled by Dh^-0.5), k, v [B, H, T, Dh], kv_lens [B] int32 valid
    keys (padding contiguous; a row with kv_len = 0 is the mean of the T
    values) -> [B, H, T, Dh] in q's dtype. Beyond MAX_KERNEL_T
    frames (read at call time) K8 `online_flash_attention` takes over
    (:1048-1049; its launch counts for K8, not here). CPU tensors run the
    plain version (any Dh, f32 or bf16); CUDA tensors launch the no-bias
    instantiation of `csrc/gated_attention.cu`, which takes bf16 q, k, v and
    head dim 64. No model calls it. Forward-only."""
    if q.shape[2] > MAX_KERNEL_T:
        return online_flash_attention(q, k, v, kv_lens)
    if on_cpu(q, k, v, kv_lens):
        return flash_attention_reference(q, k, v, kv_lens)
    out = _gated_launch(q, k, v, None, None, kv_lens, -1e9, 0.0)
    flash_attention.launches += 1
    return out


flash_attention.launches = 0  # CUDA launches since the last reset


def gated_bias_attention_outproj_reference(qkv, residual, pos_bias, gate, wo, bo, kv_lens,
                                           num_heads: int):
    """Plain version of K11 at T <= MAX_KERNEL_T (the cell :360-403): K6's
    math with the gated bias, scores (q.k) * Dh^-0.5 + gate * pos_bias (the
    product, then the sum) before the -1e9 key mask, P normalised and cast
    to qkv's dtype, the heads concatenated in f32, then K6's f32 per-row
    quantization, int8 out-proj and ((f32(acc) * s) * wos + bo) + residual,
    one cast to qkv's dtype. wo: an nn.Linear weight or its (codes, scales)
    pair."""
    ctx = attention_reference(qkv, kv_lens, num_heads, out_dtype=torch.float32,
                              bias=(pos_bias, gate))
    return _outproj_reference(ctx, residual, wo, bo, qkv.dtype)


def gated_bias_attention_outproj(qkv, residual, pos_bias, gate, wo, bo, kv_lens,
                                 num_heads: int):
    """residual + out_proj(gated-bias MHA(qkv)) with the int8 W8A8
    out-projection: K11, WavLM's fused attention (the ``wavlm_fuse`` option).

    The argument order is the JAX function's. qkv [B, T, 3C] bf16 (the
    unscaled fused projection), residual [B, T, C] bf16, pos_bias [H, T, T]
    f32 (shared by the utterances and the layers; its rows may be padded,
    `_bias_row_stride`), gate [B, H, T] f32, wo
    the cached (codes [C, C] int8, scales [C] f32) pair in nn.Linear layout
    (a raw weight is quantized here), bo [C] f32, kv_lens [B] int32 (padding
    contiguous; a row with kv_len = 0 attends to its T keys alike). Beyond
    MAX_KERNEL_T frames (read at call time): the heads split with q
    pre-scaled in qkv's dtype, K9 (which hands over to K10), then residual +
    int8_matmul (:466-477; those launches count for K10). CPU tensors run the plain versions; CUDA tensors launch
    the gated packed instantiation of `csrc/gated_attention.cu` (f32
    context), `csrc/quant_rows.cu` (f32 quantizer) and `csrc/gemm_s8.cu`
    (out-proj, bias, residual), head dim 64. Forward-only."""
    wo_q, wo_s = as_quantized_cols(wo)
    B, T, C3 = qkv.shape
    C = C3 // 3
    if T > MAX_KERNEL_T:
        out = gated_bias_attention(*_split_heads(qkv, num_heads), pos_bias.float(),
                                   gate.float(), kv_lens)
        out = out.transpose(1, 2).reshape(B, T, C)
        return residual + int8_matmul(out, (wo_q, wo_s), bo, out_dtype=residual.dtype)
    if on_cpu(qkv, residual, pos_bias, gate, wo_q, wo_s, bo, kv_lens):
        return gated_bias_attention_outproj_reference(qkv, residual, pos_bias, gate,
                                                      (wo_q, wo_s), bo, kv_lens, num_heads)
    require(residual, "residual", torch.bfloat16, (B, T, C))
    require(wo_q, "wo codes", torch.int8, (C, C))
    refuse_grad("K11 gated_bias_attention_outproj", qkv, residual, pos_bias, gate, bo)
    with torch.cuda.device(qkv.device):
        ctx = _attention(qkv, kv_lens, num_heads, out_f32=True, bias=(pos_bias, gate))
        a8, s_a = quant_rows(ctx)  # K6's f32 quantizer (:396-397)
        y = gemm_s8(a8, wo_q, mode=GEMM_LINEAR, row_scale=s_a, col_scale=wo_s, bias=bo,
                    residual=residual.view(B * T, C))
    gated_bias_attention_outproj.launches += 1
    return y.view(B, T, C)


gated_bias_attention_outproj.launches = 0  # CUDA launches since the last reset
