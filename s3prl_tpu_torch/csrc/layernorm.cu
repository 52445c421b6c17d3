// Row LayerNorm with f32 statistics, bf16 out: the LN prologue of the
// attention block (s3prl_tpu/kernels/flash_attention.py:724-729, then the
// bf16 cast at :729) and of the FFN block (ffn.py:272-275), and the postnorm
// epilogue LN of both (flash_attention.py:758-762, ffn.py:294-296), whose
// input is the f32 residual sum.
//
// Bound: device-memory bandwidth (one read, one write per element). One
// warp per row; the row is read three times (mean, variance as the mean of
// squared deviations like the Pallas kernels, normalise) and the second and
// third reads hit the L1 cache.
#include "common.cuh"

namespace {

using s3::bf16;

constexpr int kWarps = 8;

template <typename T>
__global__ void __launch_bounds__(kWarps * 32)
    layernorm_kernel(const T* __restrict__ x, const float* __restrict__ gamma,
                     const float* __restrict__ beta, bf16* __restrict__ out, int rows,
                     int cols, float eps) {
  const int row = blockIdx.x * kWarps + threadIdx.x / 32;
  if (row >= rows) return;
  const int lane = threadIdx.x % 32;
  const T* xr = x + static_cast<size_t>(row) * cols;
  float s = 0.f;
  for (int c = lane; c < cols; c += 32) s += s3::to_float(xr[c]);
  const float mean = s3::warp_sum(s) / cols;
  float v = 0.f;
  for (int c = lane; c < cols; c += 32) {
    const float d = s3::to_float(xr[c]) - mean;
    v += d * d;
  }
  const float rstd = rsqrtf(s3::warp_sum(v) / cols + eps);
  bf16* orow = out + static_cast<size_t>(row) * cols;
  for (int c = lane; c < cols; c += 32) {
    orow[c] = __float2bfloat16_rn((s3::to_float(xr[c]) - mean) * rstd * gamma[c] + beta[c]);
  }
}

}  // namespace

extern "C" int s3_layernorm(const void* x, int x_is_f32, const void* gamma, const void* beta,
                            void* out, int rows, int cols, float eps, void* stream) {
  const dim3 grid((rows + kWarps - 1) / kWarps);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const float* g = static_cast<const float*>(gamma);
  const float* b = static_cast<const float*>(beta);
  bf16* o = static_cast<bf16*>(out);
  if (x_is_f32) {
    layernorm_kernel<float><<<grid, kWarps * 32, 0, st>>>(static_cast<const float*>(x), g, b, o,
                                                          rows, cols, eps);
  } else {
    layernorm_kernel<bf16><<<grid, kWarps * 32, 0, st>>>(static_cast<const bf16*>(x), g, b, o,
                                                         rows, cols, eps);
  }
  return static_cast<int>(cudaGetLastError());
}
