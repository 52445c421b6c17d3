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
// stack built in HBM. Here a block owns a run of output frames of one
// (utterance, group) and keeps their whole input window, frames + k - 1 rows
// of 64 channels, in shared memory, loaded once: the im2col row of frame t at
// tap j is window row t + j, so every A operand of every tap is a view of the
// window (no shift stack, no im2col, x read about twice). Only the group's
// weights stream through a ring.
//
// K16a, posconv_bf16_kernel (wgmma): 256 frames a block, so each group's 1 MB
// of weights is read once per 256 frames. The window (256 + k - 1 rows of
// 128 bytes, 49 KB at k = 128) comes by TMA in the 128-byte swizzle, boxes of
// 128 rows whose rows before frame 0 and past T read as 0. A wgmma
// shared-memory descriptor cannot start at an arbitrary row inside an 8-row
// core matrix, so the A operand comes from registers: ldmatrix takes one row
// address per lane, so tap j's fragment is loaded from window rows t + j
// (the swizzle, chunk ^ (row % 8), keeps the 8 rows of each 8x8 matrix in
// 8 different bank groups) and fed to wgmma m64n64k16 with A in registers
// and B, the tap's [64 n, 64 c] weight tile, K-major in shared memory. One
// producer warp streams the taps by TMA, four 8 KB tiles a stage through a
// ring of four stages; two consumer warpgroups each own 128 frames (two
// m64 accumulators, 64 f32 registers a thread) and double-buffer the A
// fragments, so tap j + 1's ldmatrix runs while tap j's products do
// (wait_group 1). The epilogue applies bias and GELU straight from the
// accumulator registers.
//
// K16b, posconv_q8_kernel (WMMA, int8): one block owns 128 output frames; 8
// warps (4 along the frames x 2 along the 64 output channels) each hold a
// 32 x 32 accumulator of WMMA 16x16x16 fragments; 4 taps of weights a stage
// through a two-stage cp.async pipeline. A WMMA fragment must start 32-byte
// aligned at any row, so the int8 window is 4 slabs of 16 channels, each row
// in a 32-byte cell. The epilogue stages one 16x16 fragment per warp in
// shared memory and writes 8 channels a lane. Its move to the register-A
// wgmma design above is later work.
#include <mma.h>

#include "hopper.cuh"

namespace {

using namespace nvcuda;
using namespace s3;

constexpr int kCg = 64;  // channels per group

// ---- K16a: bf16, wgmma ----
constexpr int kFrames = 256;                     // output frames per block
constexpr int kConsumers = 2;                    // warpgroups of 128 frames
constexpr int kThreadsBf = kConsumers * 128 + 32;  // + the producer warp
constexpr int kBoxRows = 128;                    // window rows per TMA box
constexpr int kBoxBytes = kBoxRows * kCg * 2;    // 16 KB
constexpr int kTapBytes = kCg * kCg * 2;         // one tap's [64 n, 64 c] bf16 tile
constexpr int kTapsStage = 4;
constexpr int kStagesBf = 4;
constexpr int kStageBytesBf = kTapsStage * kTapBytes;  // 32 KB

__host__ __device__ constexpr int window_boxes(int k) {
  return (kFrames + k - 1 + kBoxRows - 1) / kBoxRows;
}
__host__ __device__ constexpr int smem_bf16(int k) {  // window, ring, barriers, alignment slack
  return window_boxes(k) * kBoxBytes + kStagesBf * kStageBytesBf + 8 * (1 + 2 * kStagesBf) + 1024;
}

// The m64nNk16 A fragment of 16 window rows (this warp's) at 16 channels:
// lane l addresses row `row` (its row of the four 8x8 matrices) and 16-byte
// chunk `chunk` of the swizzled window.
__device__ __forceinline__ void ldmatrix_a(uint32_t (&a)[4], uint32_t win, int row, int chunk) {
  const uint32_t addr = win + row * 128 + ((chunk ^ (row & 7)) << 4);
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0, %1, %2, %3}, [%4];\n"
               : "=r"(a[0]), "=r"(a[1]), "=r"(a[2]), "=r"(a[3])
               : "r"(addr));
}

// Tap j's A fragments, both 64-frame subtiles x the 4 channel steps.
__device__ __forceinline__ void load_tap(uint32_t (&a)[2][4][4], uint32_t win, int row0, int hi,
                                         int j) {
#pragma unroll
  for (int s = 0; s < 2; ++s)
#pragma unroll
    for (int kk = 0; kk < kCg / 16; ++kk) ldmatrix_a(a[s][kk], win, row0 + 64 * s + j, 2 * kk + hi);
}

// Tap j's products: both subtiles x the 4 channel steps against the tap's
// weight tile at w_tile.
__device__ __forceinline__ void mma_tap(float (&acc)[2][32], const uint32_t (&a)[2][4][4],
                                        uint32_t w_tile) {
#pragma unroll
  for (int kk = 0; kk < kCg / 16; ++kk) {
    const uint64_t desc = desc128(w_tile + 32 * kk);
#pragma unroll
    for (int s = 0; s < 2; ++s) wgmma_rs<0>(acc[s], a[s][kk], desc);
  }
}

__global__ void __launch_bounds__(kThreadsBf, 1)
    posconv_bf16_kernel(const __grid_constant__ CUtensorMap tm_x,
                        const __grid_constant__ CUtensorMap tm_w, const float* __restrict__ bias,
                        bf16* __restrict__ out, int T, int k) {
  extern __shared__ unsigned char smem_raw[];
  const uint32_t raw = smem_u32(smem_raw);
  const uint32_t win = (raw + 1023) & ~1023u;  // the swizzle pattern repeats every 1024 bytes
  const int boxes = window_boxes(k);
  const uint32_t ring = win + boxes * kBoxBytes;
  const uint32_t win_bar = ring + kStagesBf * kStageBytesBf;
  const uint32_t full = win_bar + 8, empty = full + 8 * kStagesBf;
  const int t0 = blockIdx.x * kFrames, b = blockIdx.y, g = blockIdx.z, G = gridDim.z;
  const int C = G * kCg, n_stages = k / kTapsStage;
  const int tid = threadIdx.x;

  if (tid == 0) {
    mbar_init(win_bar, 1);
#pragma unroll
    for (int s = 0; s < kStagesBf; ++s) {
      mbar_init(full + 8 * s, 1);
      mbar_init(empty + 8 * s, kConsumers);
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();

  if (tid >= kConsumers * 128) {  // the producer warp: one thread issues every load
    if (tid == kConsumers * 128) {
      // window row p holds input frame t0 + p - k/2
      mbar_expect_tx(win_bar, boxes * kBoxBytes);
      for (int i = 0; i < boxes; ++i)
        tma_load_3d(win + i * kBoxBytes, &tm_x, g * kCg, t0 - k / 2 + i * kBoxRows, b, win_bar);
      for (int st = 0; st < n_stages; ++st) {
        const int s = st % kStagesBf;
        mbar_wait(empty + 8 * s, ((st / kStagesBf) & 1) ^ 1);  // a fresh ring passes
        mbar_expect_tx(full + 8 * s, kStageBytesBf);
#pragma unroll
        for (int tt = 0; tt < kTapsStage; ++tt)
          tma_load_2d(ring + s * kStageBytesBf + tt * kTapBytes, &tm_w,
                      (st * kTapsStage + tt) * kCg, g * kCg, full + 8 * s);
      }
    }
    return;
  }

  const int wg = tid / 128, warp = (tid % 128) / 32, lane = tid % 32;
  const bool signals = tid % 128 == 0;  // hands the warpgroup's stages back
  // ldmatrix: lane l addresses row l % 8 of matrix l / 8 (rows + 8 for odd
  // matrices, channels + 8 for the last two)
  const int row0 = wg * 128 + warp * 16 + (lane & 7) + ((lane >> 3) & 1) * 8, hi = lane >> 4;
  float acc[2][32];
#pragma unroll
  for (int s = 0; s < 2; ++s)
#pragma unroll
    for (int i = 0; i < 32; ++i) acc[s][i] = 0.f;
  uint32_t a_even[2][4][4], a_odd[2][4][4];  // the fragments of even and odd taps
  mbar_wait(win_bar, 0);
  load_tap(a_even, win, row0, hi, 0);
  for (int st = 0; st < n_stages; ++st) {
    const int s = st % kStagesBf;
    const uint32_t w_s = ring + s * kStageBytesBf;
    mbar_wait(full + 8 * s, (st / kStagesBf) & 1);
#pragma unroll
    for (int tt = 0; tt < kTapsStage; ++tt) {
      const int j = st * kTapsStage + tt;
      wg_fence();
      if (tt % 2 == 0) {
        mma_tap(acc, a_even, w_s + tt * kTapBytes);
      } else {
        mma_tap(acc, a_odd, w_s + tt * kTapBytes);
      }
      wg_commit();
      wg_wait_one();  // tap j - 1's products are done: its fragments and stage are free
      if (tt == 0 && st > 0 && signals) mbar_arrive(empty + 8 * ((st - 1) % kStagesBf));
      if (j + 1 < k) {
        if (tt % 2 == 0) {
          load_tap(a_odd, win, row0, hi, j + 1);
        } else {
          load_tap(a_even, win, row0, hi, j + 1);
        }
      }
    }
  }
  wg_wait_all();
  fence_regs(acc[0]);
  fence_regs(acc[1]);

  // this thread's rows: frames rw and rw + 8 of each 64-frame subtile,
  // channels 8c + cq and 8c + cq + 1
  const int rw = wg * 128 + warp * 16 + lane / 4, cq = 2 * (lane % 4);
#pragma unroll
  for (int s = 0; s < 2; ++s) {
#pragma unroll
    for (int half = 0; half < 2; ++half) {
      const int t = t0 + rw + 64 * s + 8 * half;
      if (t >= T) continue;
      bf16* orow = out + (static_cast<size_t>(b) * T + t) * C + g * kCg + cq;
#pragma unroll
      for (int c = 0; c < 8; ++c) {
        const int ch = g * kCg + 8 * c + cq;
        const float v0 = gelu_erf(__fadd_rn(acc[s][4 * c + 2 * half], bias[ch]));
        const float v1 = gelu_erf(__fadd_rn(acc[s][4 * c + 2 * half + 1], bias[ch + 1]));
        *reinterpret_cast<__nv_bfloat162*>(orow + 8 * c) = __floats2bfloat162_rn(v0, v1);
      }
    }
  }
}

// ---- K16b: int8, WMMA ----
constexpr int kBM = 128;       // output frames per block
constexpr int kThreads = 256;  // 8 warps: 4 along the frames x 2 along the channels
constexpr int kWM = 32, kWN = 32;
constexpr int kFM = kWM / 16, kFN = kWN / 16;
// window [4 slabs][rows][32-byte cell]; a stage holds 4 taps of weights as
// [16 slabs][64 channels][16 bytes]
constexpr int kSlabs = kCg / 16;
constexpr int kCell = 32;
constexpr int kTapsQ8 = 4;
constexpr int kStageQ8 = kTapsQ8 * kSlabs * kCg * 16;

__host__ __device__ constexpr int window_bytes_q8(int rows) { return kSlabs * rows * kCell; }

__global__ void __launch_bounds__(kThreads)
    posconv_q8_kernel(const int8_t* __restrict__ x_, const int8_t* __restrict__ w_,
                      const float* __restrict__ bias, const float* __restrict__ xs,
                      const float* __restrict__ ws, void* __restrict__ out, int out_f32, int T,
                      int k) {
  extern __shared__ __align__(128) unsigned char smem[];

  const int t0 = blockIdx.x * kBM, b = blockIdx.y, g = blockIdx.z, G = gridDim.z;
  const int C = G * kCg, K = k * kCg, rows = kBM + k - 1, pad = k / 2;
  const int tid = threadIdx.x, warp = tid / 32, lane = tid % 32;
  const int wm = warp / 2, wn = warp % 2;
  const int8_t* x = x_ + static_cast<size_t>(b) * T * C + g * kCg;
  const int8_t* w = w_ + static_cast<size_t>(g) * kCg * K;
  unsigned char* win = smem;
  unsigned char* stages = smem + window_bytes_q8(rows);

  // the window: row p holds input frame t0 + p - pad (zeros outside [0, T))
  constexpr int kChunks = kCg / 16;  // 16-byte chunks a row
  for (int i = tid; i < rows * kChunks; i += kThreads) {
    const int p = i / kChunks, c = i % kChunks, tin = t0 + p - pad;
    const bool ok = tin >= 0 && tin < T;
    const int8_t* src = ok ? x + static_cast<size_t>(tin) * C + c * 16 : x;
    cp_async16(win + (c * rows + p) * kCell, src, ok);
  }
  // one stage: taps j0 .. j0 + kTapsQ8 - 1 of the 64 output channels' weights
  auto load_stage = [&](int s, int j0) {
    unsigned char* dst0 = stages + s * kStageQ8;
    constexpr int kPerRow = kTapsQ8 * kCg / 16;
    for (int i = tid; i < kCg * kPerRow; i += kThreads) {
      const int n = i / kPerRow, c = i % kPerRow;
      cp_async16(dst0 + (c * kCg + n) * 16, w + static_cast<size_t>(n) * K + j0 * kCg + c * 16,
                 true);
    }
  };
  load_stage(0, 0);
  cp_async_commit();  // the window and the first stage

  wmma::fragment<wmma::accumulator, 16, 16, 16, int> acc[kFM][kFN];
#pragma unroll
  for (int i = 0; i < kFM; ++i)
#pragma unroll
    for (int j = 0; j < kFN; ++j) wmma::fill_fragment(acc[i][j], 0);

  const int n_stages = k / kTapsQ8;
  for (int st = 0; st < n_stages; ++st) {
    if (st + 1 < n_stages) {
      load_stage((st + 1) & 1, (st + 1) * kTapsQ8);
      cp_async_commit();
      cp_async_wait<1>();
    } else {
      cp_async_wait<0>();
    }
    __syncthreads();
    const unsigned char* bs = stages + (st & 1) * kStageQ8;
#pragma unroll
    for (int tt = 0; tt < kTapsQ8; ++tt) {
      const int j = st * kTapsQ8 + tt;  // tap: frame t reads window row t - t0 + j
#pragma unroll
      for (int kk = 0; kk < kCg / 16; ++kk) {
        wmma::fragment<wmma::matrix_a, 16, 16, 16, signed char, wmma::row_major> af[kFM];
        wmma::fragment<wmma::matrix_b, 16, 16, 16, signed char, wmma::col_major> bfr[kFN];
#pragma unroll
        for (int i = 0; i < kFM; ++i) {
          const int p = wm * kWM + i * 16 + j;
          wmma::load_matrix_sync(
              af[i], reinterpret_cast<const signed char*>(win + (kk * rows + p) * kCell), kCell);
        }
#pragma unroll
        for (int jn = 0; jn < kFN; ++jn) {
          const int n0 = wn * kWN + jn * 16;
          wmma::load_matrix_sync(
              bfr[jn],
              reinterpret_cast<const signed char*>(bs + ((tt * kSlabs + kk) * kCg + n0) * 16), 16);
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
  int* stage = reinterpret_cast<int*>(smem) + warp * 256;
  const int r = lane / 2, c0 = (lane % 2) * 8;
  const float x_scale = xs[b * G + g];
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
          y = __fmul_rn(y, __fmul_rn(x_scale, ws[ch]));  // f32(acc) * f32(xs * ws)
          v[e] = gelu_erf(__fadd_rn(y, bias[ch]));
        }
        const size_t off = (static_cast<size_t>(b) * T + t) * C + g * kCg + n;
        if (out_f32) {
          store8(static_cast<float*>(out) + off, v);
        } else {
          store8(static_cast<bf16*>(out) + off, v);
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
    load8(x + base + static_cast<size_t>(i / 8) * C + (i % 8) * 8, v);
#pragma unroll
    for (int e = 0; e < 8; ++e) amax = fmaxf(amax, fabsf(v[e]));
  }
  amax = warp_max(amax);
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
    load8(x + off, v);
    alignas(8) int8_t c[8];
#pragma unroll
    for (int e = 0; e < 8; ++e) c[e] = quant_code(v[e] / s);
    *reinterpret_cast<uint2*>(q + off) = *reinterpret_cast<const uint2*>(c);
  }
}

int launch_bf16(const void* x, const void* w, const float* bias, bf16* out, int batch, int T,
                int C, int k, cudaStream_t stream) {
  const int G = C / kCg;
  // x [B, T, C]: boxes of 128 frames x one group's 64 channels
  const cuuint64_t x_dims[3] = {static_cast<cuuint64_t>(C), static_cast<cuuint64_t>(T),
                                static_cast<cuuint64_t>(batch)};
  const cuuint64_t x_strides[2] = {static_cast<cuuint64_t>(C) * 2,
                                   static_cast<cuuint64_t>(T) * C * 2};
  const cuuint32_t x_box[3] = {kCg, kBoxRows, 1};
  // w [G * 64 rows, k * 64]: one tap's [64 n, 64 c] tile a box
  const cuuint64_t w_dims[2] = {static_cast<cuuint64_t>(k) * kCg, static_cast<cuuint64_t>(C)};
  const cuuint64_t w_strides[1] = {static_cast<cuuint64_t>(k) * kCg * 2};
  const cuuint32_t w_box[2] = {kCg, kCg};
  CUtensorMap tm_x, tm_w;
  cudaError_t err =
      swizzled_map(&tm_x, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 3, x, x_dims, x_strides, x_box);
  if (err == cudaSuccess)
    err = swizzled_map(&tm_w, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 2, w, w_dims, w_strides, w_box);
  if (err == cudaSuccess)
    err = cudaFuncSetAttribute(posconv_bf16_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                               smem_bf16(k));
  if (err != cudaSuccess) return static_cast<int>(err);
  const dim3 grid((T + kFrames - 1) / kFrames, batch, G);
  posconv_bf16_kernel<<<grid, kThreadsBf, smem_bf16(k), stream>>>(tm_x, tm_w, bias, out, T, k);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// K16a's dynamic shared memory and blocks resident per SM at k taps.
extern "C" int s3_posconv_occupancy(int k, int* smem_bytes, int* blocks_per_sm) {
  *smem_bytes = smem_bf16(k);
  cudaError_t err = cudaFuncSetAttribute(
      posconv_bf16_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem_bf16(k));
  if (err == cudaSuccess)
    err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(blocks_per_sm, posconv_bf16_kernel,
                                                        kThreadsBf, smem_bf16(k));
  return static_cast<int>(err);
}

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

// x: bf16 [B, T, C] (K16a; k a multiple of 4 up to 512) or int8 codes (K16b,
// with xs [B, G] and ws [G, 64]); w: [G, 64, k * 64] of the same type; bias
// f32 [C]; out [B, T, C], bf16 or f32 (K16b only).
extern "C" int s3_posconv(const void* x, const void* w, const void* bias, const void* xs,
                          const void* ws, void* out, int q8, int out_f32, int batch, int T, int C,
                          int k, void* stream) {
  auto s = static_cast<cudaStream_t>(stream);
  if (!q8)
    return launch_bf16(x, w, static_cast<const float*>(bias), static_cast<bf16*>(out), batch, T,
                       C, k, s);
  const int smem = window_bytes_q8(kBM + k - 1) + 2 * kStageQ8;
  cudaError_t err =
      cudaFuncSetAttribute(posconv_q8_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return static_cast<int>(err);
  const dim3 grid((T + kBM - 1) / kBM, batch, C / kCg);
  posconv_q8_kernel<<<grid, kThreads, smem, s>>>(
      static_cast<const int8_t*>(x), static_cast<const int8_t*>(w),
      static_cast<const float*>(bias), static_cast<const float*>(xs),
      static_cast<const float*>(ws), out, out_f32, T, k);
  return static_cast<int>(cudaGetLastError());
}
