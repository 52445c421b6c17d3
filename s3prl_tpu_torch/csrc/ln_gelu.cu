// Row LayerNorm + GELU [+ per-row int8] over 512 channels: the row epilogue
// of the front-end kernels, and the whole of one of them.
//   x [rows, 512] bf16 or f32 -> y = GELU(LN(x)) in f32 (eps 1e-5; GELU erf,
//   or tanh with `tanh_mode`), then one of
//     kBf16 / kF32  out [rows, 512] = y cast once (bf16 rounds to nearest even);
//     kQ8           out [rows, 512] int8 = clip(rint(y / s)), scale[row] = s,
//                   s = max(absmax(y), 1e-8) / 127.
//
// Replaces the Pallas kernel `ln_gelu` (s3prl_tpu/kernels/ln_gelu.py:47,
// pallas_call at :60; bf16 or f32 in, the same dtype out), and is the
// epilogue of `fused_conv_ln_gelu` (conv_frontend.py:267, :301), which runs
// its conv as a GEMM (gemm_bf16.cu) into an f32 [rows, 512] buffer first.
// (`fused_int8_conv_ln_gelu` runs the same row epilogue inside
// int8_conv.cu.)
//
// Bound: device-memory bandwidth (about 5 operations per byte). One warp
// per row: lane l reads channels h * 256 + l * 8 .. + 7 (two coalesced
// 512-element runs), the statistics, absmax and codes are warp reductions
// over registers, and the row is read once and written once. The LN and the
// quantizer follow quant_rows.cu (common.cuh `ln_gelu_row512`,
// `quant_row512`).
#include "common.cuh"

namespace {

using s3::bf16;

constexpr int kC = 512;
constexpr int kWarps = 8;
enum OutKind { kBf16 = 0, kF32 = 1, kQ8 = 2 };

template <typename T>
__global__ void __launch_bounds__(kWarps * 32)
    ln_gelu_kernel(const T* __restrict__ x, const float* __restrict__ gamma,
                   const float* __restrict__ beta, int tanh_mode, int out_kind,
                   void* __restrict__ out, float* __restrict__ scale, int rows) {
  const int row = blockIdx.x * kWarps + threadIdx.x / 32;
  if (row >= rows) return;
  const int lane = threadIdx.x % 32;
  const size_t off = static_cast<size_t>(row) * kC;
  float v[16];
#pragma unroll
  for (int h = 0; h < 2; ++h) s3::load8(x + off + h * 256 + lane * 8, v + h * 8);
  s3::ln_gelu_row512(v, lane, gamma, beta, tanh_mode);
  if (out_kind == kQ8) {
    s3::quant_row512(v, lane, static_cast<int8_t*>(out) + off, scale + row);
    return;
  }
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    const size_t o = off + h * 256 + lane * 8;
    if (out_kind == kF32) {
      s3::store8(static_cast<float*>(out) + o, v + h * 8);
    } else {
      s3::store8(static_cast<bf16*>(out) + o, v + h * 8);
    }
  }
}

}  // namespace

extern "C" int s3_ln_gelu(const void* x, int x_is_f32, const void* gamma, const void* beta,
                          int tanh_mode, void* out, int out_kind, void* scale, int rows,
                          void* stream) {
  const dim3 grid((rows + kWarps - 1) / kWarps);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const float* g = static_cast<const float*>(gamma);
  const float* b = static_cast<const float*>(beta);
  float* sc = static_cast<float*>(scale);
  if (x_is_f32) {
    ln_gelu_kernel<float><<<grid, kWarps * 32, 0, st>>>(static_cast<const float*>(x), g, b,
                                                        tanh_mode, out_kind, out, sc, rows);
  } else {
    ln_gelu_kernel<bf16><<<grid, kWarps * 32, 0, st>>>(static_cast<const bf16*>(x), g, b,
                                                       tanh_mode, out_kind, out, sc, rows);
  }
  return static_cast<int>(cudaGetLastError());
}
