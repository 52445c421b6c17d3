// The grouped conv positional embedding + GELU of wav2vec2 / HuBERT / WavLM
// (k = 128 taps, 16 groups of cg = 64 channels, same padding, the last
// frame dropped), one source for two Pallas kernels
// (s3prl_tpu/kernels/posconv.py):
//   - K16a `pos_conv_gelu` (pallas_call :182, cell `_kernel` :50): bf16 x,
//     the group's weight in bf16, f32 sums, then + bias (f32), erf GELU and
//     one cast to bf16;
//   - K16b `pos_conv_gelu_q8` (pallas_call :137, cell `_kernel_q8` :64):
//     int8 codes of x with one scale xs per (utterance, group), int8 weight
//     codes with one scale ws per (group, out channel), exact int32 sums, then
//     y = f32(acc) * f32(xs * ws) + bias, erf GELU, one cast to x's dtype
//     (bf16 or f32). posconv_quant_kernel writes the codes and xs first.
//
// out[b, t, g*64 + n] = GELU(sum_{j < k, c < 64} x[b, t + j - k/2, g*64 + c]
//                             * w[g, n, j*64 + c] + bias[g*64 + n])
// with x = 0 outside [0, T): rows t + j - k/2 run from t - k/2 to t + k/2 - 1,
// the k//2 zero rows on the left and k//2 - 1 on the right of the same-pad
// conv whose last frame is dropped. The weights are tap-major per group,
// [G, 64 (n), k * 64] (nn.Linear layout; `posconv_gemm_weight`,
// `quantize_posconv_weight`).
//
// Bound: tensor-core throughput (HuBERT-Large at B = 32 x 10 s: 2 * 15,968
// rows * 8,192 * 1,024 = 0.27 TFLOP, against 41 MB of x, out and weights).
// The TPU kernel feeds its matrix unit long-K GEMMs from a TC-wide shift
// stack built in HBM. Here one block owns 128 output frames of one
// (utterance, group) and keeps their whole input window, 128 + k - 1 rows of
// 64 channels (41 KB in bf16), in shared memory, loaded once: the im2col row
// of frame t at tap j is window row t + j, so every A fragment of every tap
// is a strided view of the window (no shift stack, no im2col, x read about
// twice). Only the group's weights stream, 2 (bf16) or 4 (int8) taps per
// stage through a two-stage cp.async pipeline. 8 warps (4 along the frames x
// 2 along the 64 output channels) each hold a 32 x 32 accumulator of WMMA
// 16x16x16 fragments. A WMMA fragment must start 32-byte aligned at any
// row, so a bf16 window row is 80 elements (160 bytes) and the int8 window
// is 4 slabs of 16 channels, each row in a 32-byte cell. The epilogue stages
// one 16x16 fragment per warp in shared memory and writes 8 channels a lane.
// wgmma, TMA and a persistent schedule over the group's frames (so that its
// weights stream once, not once per 128 frames) are later work.
#include <mma.h>

#include <type_traits>

#include "common.cuh"

namespace {

using namespace nvcuda;
using s3::bf16;

constexpr int kCg = 64;          // channels per group
constexpr int kBM = 128;         // output frames per block
constexpr int kThreads = 256;    // 8 warps: 4 along the frames x 2 along the channels
constexpr int kWM = 32, kWN = 32;
constexpr int kFM = kWM / 16, kFN = kWN / 16;

// bf16: window rows of 80 elements; a stage holds 2 taps of weights, rows of
// 2 * 64 + 8 elements (272 bytes: 16-byte loads of 8 neighbouring rows fall
// in 8 different bank groups)
constexpr int kLdA = kCg + 16;
constexpr int kTapsBf = 2;
constexpr int kLdB = kTapsBf * kCg + 8;
constexpr int kStageBf = kCg * kLdB * 2;
// int8: window [4 slabs][rows][32-byte cell]; a stage holds 4 taps of
// weights as [16 slabs][64 channels][16 bytes]
constexpr int kSlabs = kCg / 16;
constexpr int kCell = 32;
constexpr int kTapsQ8 = 4;
constexpr int kStageQ8 = kTapsQ8 * kSlabs * kCg * 16;

__host__ __device__ constexpr int window_bytes(bool q8, int rows) {
  return q8 ? kSlabs * rows * kCell : rows * kLdA * 2;
}

__host__ __device__ constexpr int stage_bytes(bool q8) { return q8 ? kStageQ8 : kStageBf; }

template <bool kQ8>
__global__ void __launch_bounds__(kThreads)
    posconv_kernel(const void* __restrict__ x_, const void* __restrict__ w_,
                   const float* __restrict__ bias, const float* __restrict__ xs,
                   const float* __restrict__ ws, void* __restrict__ out, int out_f32, int T,
                   int k) {
  using Elem = typename std::conditional<kQ8, signed char, bf16>::type;
  using Acc = typename std::conditional<kQ8, int, float>::type;
  constexpr int kTaps = kQ8 ? kTapsQ8 : kTapsBf;
  extern __shared__ __align__(128) unsigned char smem[];

  const int t0 = blockIdx.x * kBM, b = blockIdx.y, g = blockIdx.z, G = gridDim.z;
  const int C = G * kCg, K = k * kCg, rows = kBM + k - 1, pad = k / 2;
  const int tid = threadIdx.x, warp = tid / 32, lane = tid % 32;
  const int wm = warp / 2, wn = warp % 2;
  const Elem* x = static_cast<const Elem*>(x_) + static_cast<size_t>(b) * T * C + g * kCg;
  const Elem* w = static_cast<const Elem*>(w_) + static_cast<size_t>(g) * kCg * K;
  unsigned char* win = smem;
  unsigned char* stages = smem + window_bytes(kQ8, rows);

  // the window: row p holds input frame t0 + p - pad (zeros outside [0, T))
  constexpr int kChunks = kCg * static_cast<int>(sizeof(Elem)) / 16;  // 16-byte chunks a row
  for (int i = tid; i < rows * kChunks; i += kThreads) {
    const int p = i / kChunks, c = i % kChunks, tin = t0 + p - pad;
    const bool ok = tin >= 0 && tin < T;
    const Elem* src = ok ? x + static_cast<size_t>(tin) * C + c * (16 / sizeof(Elem)) : x;
    void* dst = kQ8 ? static_cast<void*>(win + (c * rows + p) * kCell)
                    : static_cast<void*>(win + (p * kLdA + c * 8) * 2);
    s3::cp_async16(dst, src, ok);
  }
  // one stage: taps j0 .. j0 + kTaps - 1 of the 64 output channels' weights
  auto load_stage = [&](int s, int j0) {
    unsigned char* dst0 = stages + s * stage_bytes(kQ8);
    constexpr int kPerRow = kTaps * kCg * static_cast<int>(sizeof(Elem)) / 16;
    for (int i = tid; i < kCg * kPerRow; i += kThreads) {
      const int n = i / kPerRow, c = i % kPerRow;
      const Elem* src = w + static_cast<size_t>(n) * K + j0 * kCg + c * (16 / sizeof(Elem));
      void* dst = kQ8 ? static_cast<void*>(dst0 + (c * kCg + n) * 16)
                      : static_cast<void*>(dst0 + (n * kLdB + c * 8) * 2);
      s3::cp_async16(dst, src, true);
    }
  };
  load_stage(0, 0);
  s3::cp_async_commit();  // the window and the first stage

  wmma::fragment<wmma::accumulator, 16, 16, 16, Acc> acc[kFM][kFN];
#pragma unroll
  for (int i = 0; i < kFM; ++i)
#pragma unroll
    for (int j = 0; j < kFN; ++j) wmma::fill_fragment(acc[i][j], 0);

  const int n_stages = k / kTaps;
  for (int st = 0; st < n_stages; ++st) {
    if (st + 1 < n_stages) {
      load_stage((st + 1) & 1, (st + 1) * kTaps);
      s3::cp_async_commit();
      s3::cp_async_wait<1>();
    } else {
      s3::cp_async_wait<0>();
    }
    __syncthreads();
    const unsigned char* bs = stages + (st & 1) * stage_bytes(kQ8);
#pragma unroll
    for (int tt = 0; tt < kTaps; ++tt) {
      const int j = st * kTaps + tt;  // tap: frame t reads window row t - t0 + j
#pragma unroll
      for (int kk = 0; kk < kCg / 16; ++kk) {
        wmma::fragment<wmma::matrix_a, 16, 16, 16, Elem, wmma::row_major> af[kFM];
        wmma::fragment<wmma::matrix_b, 16, 16, 16, Elem, wmma::col_major> bfr[kFN];
#pragma unroll
        for (int i = 0; i < kFM; ++i) {
          const int p = wm * kWM + i * 16 + j;
          if constexpr (kQ8) {
            wmma::load_matrix_sync(
                af[i], reinterpret_cast<const Elem*>(win + (kk * rows + p) * kCell), kCell);
          } else {
            wmma::load_matrix_sync(af[i], reinterpret_cast<const Elem*>(win) + p * kLdA + kk * 16,
                                   kLdA);
          }
        }
#pragma unroll
        for (int jn = 0; jn < kFN; ++jn) {
          const int n0 = wn * kWN + jn * 16;
          if constexpr (kQ8) {
            wmma::load_matrix_sync(
                bfr[jn], reinterpret_cast<const Elem*>(bs + ((tt * kSlabs + kk) * kCg + n0) * 16),
                16);
          } else {
            wmma::load_matrix_sync(
                bfr[jn], reinterpret_cast<const Elem*>(bs) + n0 * kLdB + tt * kCg + kk * 16, kLdB);
          }
        }
#pragma unroll
        for (int i = 0; i < kFM; ++i)
#pragma unroll
          for (int jn = 0; jn < kFN; ++jn) wmma::mma_sync(acc[i][jn], af[i], bfr[jn], acc[i][jn]);
      }
    }
    __syncthreads();  // this stage is refilled two steps on; the window is reused below
  }

  // Epilogue: a 16x16 staging square per warp in the (consumed) window.
  Acc* stage = reinterpret_cast<Acc*>(smem) + warp * 256;
  const int r = lane / 2, c0 = (lane % 2) * 8;
  const float x_scale = kQ8 ? xs[b * G + g] : 0.f;
#pragma unroll
  for (int i = 0; i < kFM; ++i) {
#pragma unroll
    for (int jn = 0; jn < kFN; ++jn) {
      wmma::store_matrix_sync(stage, acc[i][jn], 16, wmma::mem_row_major);
      __syncwarp();
      const int t = t0 + wm * kWM + i * 16 + r;
      const int n = wn * kWN + jn * 16 + c0;
      if (t < T) {
        float v[8];
#pragma unroll
        for (int e = 0; e < 8; ++e) {
          const int ch = g * kCg + n + e;
          float y = static_cast<float>(stage[r * 16 + c0 + e]);
          if constexpr (kQ8) y = __fmul_rn(y, __fmul_rn(x_scale, ws[ch]));  // f32(acc) * f32(xs * ws)
          v[e] = s3::gelu_erf(__fadd_rn(y, bias[ch]));
        }
        const size_t off = (static_cast<size_t>(b) * T + t) * C + g * kCg + n;
        if (out_f32) {
          s3::store8(static_cast<float*>(out) + off, v);
        } else {
          s3::store8(static_cast<bf16*>(out) + off, v);
        }
      }
      __syncwarp();
    }
  }
}

// K16b's activation codes: one block per (group, utterance) finds the absmax
// of x[b, :, g*64 : g*64 + 64] over all T frames (the padding of the TPU's
// shift stack adds only zeros), xs = max(absmax, 1e-8) / 127 (a true
// division), then writes q = clip(rint(x / xs), -127, 127) (half to even) in
// x's layout [B, T, C]. The slice is read twice; the second read hits L2.
template <typename In>
__global__ void __launch_bounds__(kThreads)
    posconv_quant_kernel(const In* __restrict__ x, int8_t* __restrict__ q,
                         float* __restrict__ xs, int T) {
  __shared__ float red[kThreads / 32];
  const int g = blockIdx.x, b = blockIdx.y, G = gridDim.x, C = G * kCg;
  const size_t base = static_cast<size_t>(b) * T * C + g * kCg;
  const int n = T * (kCg / 8);  // runs of 8 channels
  float amax = 0.f;
  for (int i = threadIdx.x; i < n; i += kThreads) {
    float v[8];
    s3::load8(x + base + static_cast<size_t>(i / 8) * C + (i % 8) * 8, v);
#pragma unroll
    for (int e = 0; e < 8; ++e) amax = fmaxf(amax, fabsf(v[e]));
  }
  amax = s3::warp_max(amax);
  if (threadIdx.x % 32 == 0) red[threadIdx.x / 32] = amax;
  __syncthreads();
  amax = 0.f;
#pragma unroll
  for (int i = 0; i < kThreads / 32; ++i) amax = fmaxf(amax, red[i]);
  const float s = fmaxf(amax, 1e-8f) / 127.f;
  if (threadIdx.x == 0) xs[b * G + g] = s;
  for (int i = threadIdx.x; i < n; i += kThreads) {
    const size_t off = base + static_cast<size_t>(i / 8) * C + (i % 8) * 8;
    float v[8];
    s3::load8(x + off, v);
    alignas(8) int8_t c[8];
#pragma unroll
    for (int e = 0; e < 8; ++e) c[e] = s3::quant_code(v[e] / s);
    *reinterpret_cast<uint2*>(q + off) = *reinterpret_cast<const uint2*>(c);
  }
}

}  // namespace

extern "C" int s3_posconv_quant(const void* x, int x_is_f32, void* q, void* xs, int batch, int T,
                                int C, void* stream) {
  const dim3 grid(C / kCg, batch);
  auto s = static_cast<cudaStream_t>(stream);
  if (x_is_f32) {
    posconv_quant_kernel<float><<<grid, kThreads, 0, s>>>(
        static_cast<const float*>(x), static_cast<int8_t*>(q), static_cast<float*>(xs), T);
  } else {
    posconv_quant_kernel<bf16><<<grid, kThreads, 0, s>>>(
        static_cast<const bf16*>(x), static_cast<int8_t*>(q), static_cast<float*>(xs), T);
  }
  return static_cast<int>(cudaGetLastError());
}

// x: bf16 [B, T, C] (K16a) or int8 codes (K16b, with xs [B, G] and ws [G, 64]);
// w: [G, 64, k * 64] of the same type; bias f32 [C]; out [B, T, C], bf16 or f32
// (K16b only).
extern "C" int s3_posconv(const void* x, const void* w, const void* bias, const void* xs,
                          const void* ws, void* out, int q8, int out_f32, int batch, int T, int C,
                          int k, void* stream) {
  const int smem = window_bytes(q8, kBM + k - 1) + 2 * stage_bytes(q8);
  auto kernel = q8 ? posconv_kernel<true> : posconv_kernel<false>;
  cudaError_t err =
      cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return static_cast<int>(err);
  const dim3 grid((T + kBM - 1) / kBM, batch, C / kCg);
  kernel<<<grid, kThreads, smem, static_cast<cudaStream_t>(stream)>>>(
      x, w, static_cast<const float*>(bias), static_cast<const float*>(xs),
      static_cast<const float*>(ws), out, out_f32, T, k);
  return static_cast<int>(cudaGetLastError());
}
