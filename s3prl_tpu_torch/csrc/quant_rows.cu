// Dynamic per-row int8 quantization, the activation side of the int8
// whole-block kernels. Two kernels:
//
// quant_rows_kernel: x [rows, ld] (bf16 or f32), columns [lo, hi) ->
//   [LN ->] s = max(absmax, 1e-8) / 127, q = clip(rint(v / s), -127, 127),
//   codes written to q at the same [row, column] places, s to scale[row].
//   With gamma, v is the f32 LayerNorm (x - mean) * rsqrt(var + eps) * g + b
//   over the range (the LN prologue of `fused_attention_block`,
//   s3prl_tpu/kernels/flash_attention.py:522-531, and of `fused_int8_ffn`,
//   ffn.py:87-89, with `_quant_rows8`, conv_frontend.py:88-92); without it,
//   v = x, over one FFN chunk of the f32 fc1 output (the per-chunk requant
//   of `fused_int8_ffn`, ffn.py:100).
//
// quant_rows_bf16_kernel: K1's context quantization, in bf16
//   (flash_attention.py:605-611): s = bf16(max(absmax, bf16(1e-6)) /
//   bf16(127)), q = clip(rint(f32(bf16(x / s)))): the quotient rounds to
//   bf16 before it rounds to an integer (between 64 and 128 a bf16 step is
//   0.5), as on the TPU.
//
// Division, never a multiply by the reciprocal; rintf rounds half to even
// as jnp.round (never roundf). 1 / sqrtf is IEEE-rounded (no rsqrtf), as the
// plain version's 1 / torch.sqrt.
//
// Bound: device-memory bandwidth. One warp per row; the row is re-read per
// pass (statistics, absmax, codes) and the later reads hit the L1 cache.
#include "common.cuh"

namespace {

using s3::bf16;

constexpr int kWarps = 8;

template <typename T>
__global__ void __launch_bounds__(kWarps * 32)
    quant_rows_kernel(const T* __restrict__ x, int ld, int lo, int hi,
                      const float* __restrict__ gamma, const float* __restrict__ beta, float eps,
                      int8_t* __restrict__ q, float* __restrict__ scale, int rows) {
  const int row = blockIdx.x * kWarps + threadIdx.x / 32;
  if (row >= rows) return;
  const int lane = threadIdx.x % 32;
  const T* xr = x + static_cast<size_t>(row) * ld;
  const float n = static_cast<float>(hi - lo);
  float mean = 0.f, rstd = 1.f;
  if (gamma) {
    float s = 0.f;
    for (int c = lo + lane; c < hi; c += 32) s += s3::to_float(xr[c]);
    mean = s3::warp_sum(s) / n;
    float v = 0.f;
    for (int c = lo + lane; c < hi; c += 32) {
      const float d = s3::to_float(xr[c]) - mean;
      v += d * d;
    }
    rstd = 1.f / sqrtf(s3::warp_sum(v) / n + eps);
  }
  auto value = [&](int c) {
    const float v = s3::to_float(xr[c]);
    if (!gamma) return v;
    return __fadd_rn(__fmul_rn(__fmul_rn(v - mean, rstd), gamma[c]), beta[c]);
  };
  float amax = 0.f;
  for (int c = lo + lane; c < hi; c += 32) amax = fmaxf(amax, fabsf(value(c)));
  const float s = fmaxf(s3::warp_max(amax), 1e-8f) / 127.f;
  int8_t* qr = q + static_cast<size_t>(row) * ld;
  for (int c = lo + lane; c < hi; c += 32) qr[c] = s3::quant_code(value(c) / s);
  if (lane == 0) scale[row] = s;
}

__global__ void __launch_bounds__(kWarps * 32)
    quant_rows_bf16_kernel(const bf16* __restrict__ x, int cols, int8_t* __restrict__ q,
                           float* __restrict__ scale, int rows) {
  const int row = blockIdx.x * kWarps + threadIdx.x / 32;
  if (row >= rows) return;
  const int lane = threadIdx.x % 32;
  const bf16* xr = x + static_cast<size_t>(row) * cols;
  float amax = 0.f;
  for (int c = lane; c < cols; c += 32) amax = fmaxf(amax, fabsf(__bfloat162float(xr[c])));
  const float floor_ = __bfloat162float(__float2bfloat16_rn(1e-6f));
  const float s = __bfloat162float(__float2bfloat16_rn(fmaxf(s3::warp_max(amax), floor_) / 127.f));
  int8_t* qr = q + static_cast<size_t>(row) * cols;
  for (int c = lane; c < cols; c += 32) {
    const float v = __bfloat162float(__float2bfloat16_rn(__bfloat162float(xr[c]) / s));
    qr[c] = s3::quant_code(v);
  }
  if (lane == 0) scale[row] = s;
}

}  // namespace

extern "C" int s3_quant_rows(const void* x, int x_is_f32, int ld, int lo, int hi,
                             const void* gamma, const void* beta, float eps, void* q,
                             void* scale, int rows, void* stream) {
  const dim3 grid((rows + kWarps - 1) / kWarps);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const float* g = static_cast<const float*>(gamma);
  const float* b = static_cast<const float*>(beta);
  int8_t* qo = static_cast<int8_t*>(q);
  float* so = static_cast<float*>(scale);
  if (x_is_f32) {
    quant_rows_kernel<float><<<grid, kWarps * 32, 0, st>>>(static_cast<const float*>(x), ld, lo,
                                                           hi, g, b, eps, qo, so, rows);
  } else {
    quant_rows_kernel<bf16><<<grid, kWarps * 32, 0, st>>>(static_cast<const bf16*>(x), ld, lo, hi,
                                                          g, b, eps, qo, so, rows);
  }
  return static_cast<int>(cudaGetLastError());
}

extern "C" int s3_quant_rows_bf16(const void* x, int cols, void* q, void* scale, int rows,
                                  void* stream) {
  const dim3 grid((rows + kWarps - 1) / kWarps);
  quant_rows_bf16_kernel<<<grid, kWarps * 32, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const bf16*>(x), cols, static_cast<int8_t*>(q), static_cast<float*>(scale),
      rows);
  return static_cast<int>(cudaGetLastError());
}
