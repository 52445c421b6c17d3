"""The conv front end's kernels: ports of the Pallas kernels of
s3prl_tpu/kernels/conv_frontend.py.

- K3 `conv0_ln_gelu` (:136): the first layer of the wav2vec2/HuBERT
  extractor (C_in=1, k=10, s=5, 512 channels, no bias) writes the
  pipeline's largest tensor; `csrc/conv0_ln_gelu.cu` computes conv -> f32
  LN -> GELU in one pass and writes it once. ``gelu_mode`` is "erf" (exact,
  the bf16 and f32 paths) or "tanh" (the int8 serving path), as the Pallas
  kernel's.
- K13a `conv0_ln_gelu_q8` (:169): K3 in erf mode writing per-row int8 codes
  and f32 scales (the same source, its q8 instantiation), the head of the
  int8 conv chain.
- K13b `fused_int8_conv_ln_gelu` (:325): a stride-2 conv (k 2 or 3) over
  int8 rows, one exact int32 product per tap, each dequantized as
  (f32(acc) * row scale) * tap weight scale and summed in tap order into
  f32, then LN, erf GELU, per-row int8 (or, in the chain's last layer, one
  cast to bf16): one launch of `csrc/int8_conv.cu`, which keeps the f32
  tap sum of a 64-row tile on chip and writes only the codes.
- K14 `fused_conv_ln_gelu` (:267): the same conv in bf16 as ONE K = k * C
  GEMM on `csrc/gemm_bf16.cu` into f32, then `csrc/ln_gelu.cu`: LN, erf
  GELU, one cast.

The stride-2 taps need no copy: output row j of an utterance reads rows 2j
.. 2j + k - 1 of its input, one contiguous run of k * C elements of x [B, T,
C] at (b T + 2 j) C, so the im2col matrix is a view of x with row stride 2C
in B groups of T' rows (`_im2col`), which K14's GEMM reads as it lies (and
K13b's kernel tap by tap). An output row never reads past its own
utterance's rows.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

from ..ops.quant import as_quantized_cols, int_mm, quantize_rows
from ._build import launch
from ._common import (_ptr, gelu_tanh, gemm, ln_gelu_f32, ln_gelu_rows, on_cpu, refuse_grad,
                      require, stream_of)

GELU_MODES = ("erf", "tanh")
MID_TAPS = (2, 3)  # the mid-conv kernels' k (stride 2)


def _conv0_f32(wavs: torch.Tensor, weight: torch.Tensor, stride: int, k: int) -> torch.Tensor:
    """conv1d(wavs) [B, (T-k)//stride+1, C] in f32 with the Pallas cast
    points: the weight cast to the wav dtype, the dot accumulated in f32
    (products of bf16 values are exact in f32)."""
    w = weight.to(wavs.dtype).float()[:, 0, :]  # [C, k]
    return wavs.float().unfold(1, k, stride) @ w.t()


def conv0_ln_gelu_reference(wavs: torch.Tensor, weight: torch.Tensor,
                            scale: torch.Tensor, bias: torch.Tensor,
                            stride: int = 5, k: int = 10,
                            gelu_mode: str = "erf") -> torch.Tensor:
    """Plain version. wavs [B, T] in the model dtype, weight [C, 1, k]
    (nn.Conv1d layout) -> GELU(LN(conv1d(wavs)))[B, (T-k)//stride+1, C] in
    wavs.dtype. Cast points as the Pallas kernel: `_conv0_f32`, LN and GELU
    (erf or tanh) in f32, one cast at the end."""
    y = _conv0_f32(wavs, weight, stride, k)
    y = F.layer_norm(y, (y.shape[-1],), scale.float(), bias.float(), eps=1e-5)
    y = gelu_tanh(y) if gelu_mode == "tanh" else F.gelu(y)
    return y.to(wavs.dtype)


def _check_conv0(name: str, wavs, weight, scale, bias, stride: int, k: int) -> int:
    """What `csrc/conv0_ln_gelu.cu` takes (CUDA only); returns T'."""
    if wavs.dtype not in (torch.bfloat16, torch.float32):
        raise TypeError(f"{name}: wav dtype {wavs.dtype}, the kernel takes bf16 or f32")
    if (stride, k) != (5, 10):
        raise ValueError(f"{name}: the kernel takes k=10, stride=5, got k={k}, stride={stride}")
    T = wavs.shape[1]
    require(wavs, "wavs", wavs.dtype)
    require(weight, "weight", wavs.dtype, (512, 1, k))
    require(scale, "scale", torch.float32, (512,))
    require(bias, "bias", torch.float32, (512,))
    if T < k:
        raise ValueError(f"{name}: {T} samples, fewer than the kernel width {k}")
    refuse_grad(name, wavs, weight, scale, bias)
    return (T - k) // stride + 1


def conv0_ln_gelu(wavs: torch.Tensor, weight: torch.Tensor, scale: torch.Tensor,
                  bias: torch.Tensor, stride: int = 5, k: int = 10,
                  gelu_mode: str = "erf") -> torch.Tensor:
    """wavs [B, T] (bf16 or f32) -> GELU(LN(conv1d(wavs)))[B, (T-k)//stride+1, C],
    GELU exact ("erf") or tanh-approximate ("tanh"): K3.

    weight [C, 1, k] in wavs.dtype (nn.Conv1d layout, the transpose of the
    JAX kernel's [k, 1, C]), scale/bias [C] f32 (nn.LayerNorm). CPU tensors
    run the plain version; CUDA tensors launch the kernel, which takes
    C=512, k=10, stride=5. Forward-only."""
    if gelu_mode not in GELU_MODES:
        raise ValueError(f"conv0_ln_gelu: gelu_mode {gelu_mode!r}, one of {GELU_MODES}")
    if on_cpu(wavs, weight, scale, bias):
        return conv0_ln_gelu_reference(wavs, weight, scale, bias, stride, k, gelu_mode)
    n_frames = _check_conv0("K3 conv0_ln_gelu", wavs, weight, scale, bias, stride, k)
    B, T = wavs.shape
    out = torch.empty(B, n_frames, 512, dtype=wavs.dtype, device=wavs.device)
    if B:
        with torch.cuda.device(wavs.device):
            launch("s3_conv0_ln_gelu", wavs.data_ptr(), weight.data_ptr(),
                   scale.data_ptr(), bias.data_ptr(), out.data_ptr(), B, T,
                   n_frames, int(wavs.dtype == torch.bfloat16), int(gelu_mode == "tanh"),
                   stream_of(wavs))
        conv0_ln_gelu.launches += 1
    return out


conv0_ln_gelu.launches = 0  # CUDA launches since the last reset


def conv0_ln_gelu_q8_reference(wavs: torch.Tensor, weight: torch.Tensor, scale: torch.Tensor,
                               bias: torch.Tensor, stride: int = 5, k: int = 10):
    """Plain version of K13a (`_kernel_q8`, conv_frontend.py:106-115):
    `_conv0_f32`, LN and erf GELU in f32, then per-row int8 ->
    (codes [B, T', C] int8, scales [B, T', 1] f32)."""
    return quantize_rows(ln_gelu_f32(_conv0_f32(wavs, weight, stride, k), scale, bias))


def conv0_ln_gelu_q8(wavs: torch.Tensor, weight: torch.Tensor, scale: torch.Tensor,
                     bias: torch.Tensor, stride: int = 5, k: int = 10):
    """K3 in erf mode emitting (int8 rows [B, T', 512], per-row f32 scales
    [B, T', 1]) for the int8 conv chain: K13a. Arguments as `conv0_ln_gelu`.
    CPU tensors run the plain version; CUDA tensors launch the q8
    instantiation of `csrc/conv0_ln_gelu.cu`. Forward-only."""
    if on_cpu(wavs, weight, scale, bias):
        return conv0_ln_gelu_q8_reference(wavs, weight, scale, bias, stride, k)
    n_frames = _check_conv0("K13a conv0_ln_gelu_q8", wavs, weight, scale, bias, stride, k)
    B, T = wavs.shape
    q = torch.empty(B, n_frames, 512, dtype=torch.int8, device=wavs.device)
    s = torch.empty(B, n_frames, 1, dtype=torch.float32, device=wavs.device)
    if B:
        with torch.cuda.device(wavs.device):
            launch("s3_conv0_ln_gelu_q8", wavs.data_ptr(), weight.data_ptr(), scale.data_ptr(),
                   bias.data_ptr(), q.data_ptr(), s.data_ptr(), B, T, n_frames,
                   int(wavs.dtype == torch.bfloat16), stream_of(wavs))
        conv0_ln_gelu_q8.launches += 1
    return q, s


conv0_ln_gelu_q8.launches = 0  # CUDA launches since the last reset


def conv_gemm_weight(weight: torch.Tensor) -> torch.Tensor:
    """nn.Conv1d weight [Cout, C, k] -> K14's GEMM weight [Cout, k * C],
    tap-major: the transpose of the JAX kernel [k, C, Cout] reshaped to
    [k * C, Cout] (conv_frontend.py:292)."""
    return weight.permute(0, 2, 1).reshape(weight.shape[0], -1).contiguous()


def quantize_conv_taps(weight: torch.Tensor):
    """nn.Conv1d weight [Cout, C, k] -> K13b's per-tap int8 weights: codes
    [k, Cout, C] and scales [k, Cout], each tap quantized per output channel
    from its f32 values, as `quantize_cols(kernel[t])` (conv_frontend.py:
    360-368), in nn.Linear layout."""
    taps = [as_quantized_cols(weight[:, :, t].float()) for t in range(weight.shape[2])]
    return (torch.stack([q for q, _ in taps]).contiguous(),
            torch.stack([s for _, s in taps]).contiguous())


def _mid_shape(x: torch.Tensor, k: int, name: str) -> int:
    """T' = (T - k) // 2 + 1 of a stride-2 valid conv (0 when T < k)."""
    if k not in MID_TAPS:
        raise ValueError(f"{name}: the kernel takes k in {MID_TAPS}, got {k}")
    return max((x.shape[1] - k) // 2 + 1, 0)


def _im2col(x: torch.Tensor, k: int, t_out: int) -> torch.Tensor:
    """The stride-2 im2col rows of x [B, T, C] (contiguous) as a view [B,
    T', k * C]: row (b, j) is x[b, 2j : 2j + k] flattened, tap-major. Rows
    overlap; none reads past its utterance's T rows."""
    B, T, C = x.shape
    return x.as_strided((B, t_out, k * C), (T * C, 2 * C, 1), x.storage_offset())


def _gemm_weight(weight: torch.Tensor, C: int) -> torch.Tensor:
    """K14's [Cout, k * C] weight from an nn.Conv1d weight [Cout, C, k]
    (rebuilt here) or from the load-time cache (passed through)."""
    return conv_gemm_weight(weight) if weight.dim() == 3 else weight


def fused_conv_ln_gelu_reference(x: torch.Tensor, weight: torch.Tensor, gamma: torch.Tensor,
                                 beta: torch.Tensor) -> torch.Tensor:
    """Plain version of K14 (`_mid_kernel_bf16`, conv_frontend.py:246-263):
    the im2col rows and the weight cast to x.dtype, one K = k * C product
    accumulated in f32, LN and erf GELU in f32, one cast to x.dtype."""
    B, T, C = x.shape
    w = _gemm_weight(weight, C)
    k = w.shape[1] // C
    frames = _im2col(x.contiguous(), k, _mid_shape(x, k, "fused_conv_ln_gelu"))
    y = frames.float() @ w.to(x.dtype).float().t()
    return ln_gelu_f32(y, gamma, beta).to(x.dtype)


def fused_conv_ln_gelu(x: torch.Tensor, weight: torch.Tensor, gamma: torch.Tensor,
                       beta: torch.Tensor) -> torch.Tensor:
    """Stride-2 valid conv (k 2 or 3) + LayerNorm + erf GELU: K14.

    x [B, T, C]; weight the nn.Conv1d weight [Cout, C, k] or its tap-major
    GEMM form [Cout, k * C] (`conv_gemm_weight`, built once at load) in
    x.dtype; gamma/beta [Cout] f32 -> [B, (T-k)//2+1, Cout] in x.dtype. CPU
    tensors run the plain version; CUDA tensors launch `csrc/gemm_bf16.cu`
    on the im2col view (f32 out) and `csrc/ln_gelu.cu`, which take bf16 x
    and C = Cout = 512. Forward-only."""
    if on_cpu(x, weight, gamma, beta):
        return fused_conv_ln_gelu_reference(x, weight, gamma, beta)
    if x.dtype != torch.bfloat16:
        raise NotImplementedError(
            f"K14 fused_conv_ln_gelu on the card takes bf16 x, got {x.dtype}: the f32 "
            "front end is not ported yet (ROADMAP.md Queue 2, K14 with f32 x)")
    B, T, C = x.shape
    w = _gemm_weight(weight, C)
    k = w.shape[1] // C
    t_out = _mid_shape(x, k, "fused_conv_ln_gelu")
    require(x, "x", torch.bfloat16, (B, T, 512))
    require(w, "weight", torch.bfloat16, (512, k * 512))
    refuse_grad("K14 fused_conv_ln_gelu", x, w, gamma, beta)
    if not B * t_out:
        return x.new_empty(B, t_out, 512)
    with torch.cuda.device(x.device):
        y = gemm(_im2col(x, k, t_out), w, out_f32=True)
        out = ln_gelu_rows(y, gamma, beta, out_dtype=torch.bfloat16)
    fused_conv_ln_gelu.launches += 1
    return out.view(B, t_out, 512)


fused_conv_ln_gelu.launches = 0  # CUDA launches since the last reset


def _conv_taps(weight):
    """K13b's (codes [k, Cout, C], scales [k, Cout]) from an nn.Conv1d
    weight [Cout, C, k] (quantized here from f32) or the load-time pair."""
    if isinstance(weight, (tuple, list)):
        return tuple(weight)
    return quantize_conv_taps(weight)


def fused_int8_conv_taps_reference(xq: torch.Tensor, xs: torch.Tensor, weight) -> torch.Tensor:
    """K13b's f32 tap sum [B, T', Cout], the conv output before the LN (the
    counterpart of `int8_conv`'s test mode): per tap t, the exact int32
    product of rows x[2j + t] with the tap's codes, dequantized as (f32(acc)
    * xs[2j + t]) * ws[t], summed in tap order (tap 0 assigned)."""
    wq, ws = _conv_taps(weight)
    k = wq.shape[0]
    B, T, C = xq.shape
    N = wq.shape[1]
    t_out = _mid_shape(xq, k, "fused_int8_conv_ln_gelu")
    acc = None
    for t in range(k):
        rows = xq[:, t::2][:, :t_out].reshape(B * t_out, C)
        tap = int_mm(rows, wq[t]).float().view(B, t_out, N) * xs[:, t::2][:, :t_out] * ws[t]
        acc = tap if acc is None else acc + tap
    return acc


def fused_int8_conv_ln_gelu_reference(xq: torch.Tensor, xs: torch.Tensor, weight,
                                      gamma: torch.Tensor, beta: torch.Tensor,
                                      emit_q8: bool = True,
                                      out_dtype: torch.dtype = torch.bfloat16):
    """Plain version of K13b (`_mid_kernel`, conv_frontend.py:207-243): the
    f32 tap sum (`fused_int8_conv_taps_reference`); LN and erf GELU in f32;
    then per-row int8 (`emit_q8`) -> (codes, scales [B, T', 1]), else one
    cast -> ([B, T', Cout] out_dtype, None)."""
    y = ln_gelu_f32(fused_int8_conv_taps_reference(xq, xs, weight), gamma, beta)
    if emit_q8:
        return quantize_rows(y)
    return y.to(out_dtype), None


def int8_conv(xq: torch.Tensor, xs: torch.Tensor, wq: torch.Tensor, ws: torch.Tensor,
              gamma: torch.Tensor, beta: torch.Tensor, emit_q8: bool = True,
              out_dtype: torch.dtype = torch.bfloat16, sums: bool = False):
    """One launch of csrc/int8_conv.cu (CUDA only): K13b on xq [B, T, 512]
    int8 with row scales xs [B, T, 1] f32, the tap pair (codes [k, 512,
    512] int8, scales [k, 512] f32), gamma/beta [512] f32 -> (codes [B, T',
    512] int8, scales [B, T', 1] f32) with `emit_q8`, else ([B, T', 512]
    out_dtype (bf16 or f32), None). With `sums` (a test mode) also returns
    the f32 tap sum [B T', 512] and the LN statistics [B T', 2] (mean, 1 /
    sqrt(var + eps)) as the kernel computed them. Takes T' >= 1."""
    k = wq.shape[0]
    B, T, C = xq.shape
    t_out = _mid_shape(xq, k, "fused_int8_conv_ln_gelu")
    require(xq, "xq", torch.int8, (B, T, 512))
    require(xs, "xs", torch.float32, (B, T, 1))
    require(wq, "weight codes", torch.int8, (k, 512, 512))
    require(ws, "weight scales", torch.float32, (k, 512))
    require(gamma, "gamma", torch.float32, (512,))
    require(beta, "beta", torch.float32, (512,))
    if not emit_q8 and out_dtype not in (torch.bfloat16, torch.float32):
        raise TypeError(f"int8_conv: rows out in {out_dtype}, the kernel writes bf16 or f32")
    if not B * t_out:
        raise ValueError("int8_conv: no output row")
    if any(t.data_ptr() % 16 for t in (xq, wq)):
        raise ValueError("int8_conv: xq and the weight codes must start at 16-byte boundaries")
    dev = xq.device
    out = torch.empty(B, t_out, 512, dtype=torch.int8 if emit_q8 else out_dtype, device=dev)
    scale = torch.empty(B, t_out, 1, dtype=torch.float32, device=dev) if emit_q8 else None
    acc = torch.empty(B * t_out, 512, dtype=torch.float32, device=dev) if sums else None
    stats = torch.empty(B * t_out, 2, dtype=torch.float32, device=dev) if sums else None
    launch("s3_int8_conv", xq.data_ptr(), xs.data_ptr(), wq.data_ptr(), ws.data_ptr(),
           gamma.data_ptr(), beta.data_ptr(), B, T, t_out, k, out.data_ptr(),
           _ptr(scale), int(out.dtype == torch.float32), _ptr(acc), _ptr(stats), stream_of(xq))
    return (out, scale, acc, stats) if sums else (out, scale)


def fused_int8_conv_ln_gelu(xq: torch.Tensor, xs: torch.Tensor, weight, gamma: torch.Tensor,
                            beta: torch.Tensor, emit_q8: bool = True,
                            out_dtype: torch.dtype = torch.bfloat16):
    """Stride-2 valid conv (k 2 or 3) + LayerNorm + erf GELU over int8 rows:
    K13b. The argument order is the JAX function's.

    xq [B, T, C] int8 with per-row scales xs [B, T, 1] f32 (from K13a or an
    earlier layer); weight the nn.Conv1d weight [Cout, C, k] in f32
    (quantized per tap here) or its load-time (codes [k, Cout, C], scales
    [k, Cout]) pair (`quantize_conv_taps`); gamma/beta [Cout] f32. Returns
    (int8 [B, T', Cout], scales [B, T', 1]) with `emit_q8`, else ([B, T',
    Cout] out_dtype, None). CPU tensors run the plain version; CUDA tensors
    launch `csrc/int8_conv.cu` once (`int8_conv`: the stride-2 rows and
    their scales read in place, the f32 tap sum kept on chip), which takes
    C = Cout = 512 and writes rows in bf16 or f32. Forward-only."""
    wq, ws = _conv_taps(weight)
    if on_cpu(xq, xs, wq, ws, gamma, beta):
        return fused_int8_conv_ln_gelu_reference(xq, xs, (wq, ws), gamma, beta, emit_q8,
                                                 out_dtype)
    B = xq.shape[0]
    t_out = _mid_shape(xq, wq.shape[0], "fused_int8_conv_ln_gelu")
    refuse_grad("K13b fused_int8_conv_ln_gelu", xs, ws, gamma, beta)
    if not B * t_out:
        return (xq.new_empty(B, t_out, 512, dtype=torch.int8 if emit_q8 else out_dtype),
                xs.new_empty(B, t_out, 1) if emit_q8 else None)
    with torch.cuda.device(xq.device):
        out = int8_conv(xq, xs, wq, ws, gamma, beta, emit_q8, out_dtype)
    fused_int8_conv_ln_gelu.launches += 1
    return out


fused_int8_conv_ln_gelu.launches = 0  # CUDA launches since the last reset
