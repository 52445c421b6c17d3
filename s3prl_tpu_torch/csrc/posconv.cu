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
//     (bf16 or f32). posconv_quant_kernel finds xs first; the conv kernel
//     writes the codes into its own window.
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
// rows * 8,192 * 1,024 = 0.27 TFLOP, against 41 MB of x, out and weights;
// 0.135 ms at 1,979 TOP/s int8, 0.271 at 989 TFLOP/s bf16).
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
// K16b, posconv_q8_kernel (wgmma, int8, the transposed form): products D[64
// n, frames] = W_j[64 n, 64 c] X[frames + j, 64 c]^T, so the tap's weight is
// the register A operand (ldmatrix from the TMA ring, once a tap for 256
// frames) and the window is the shared B operand of wgmma m64n256k32, which
// int8 needs K-major: a frame's 64 channel bytes. A descriptor cannot start
// a swizzled tile at an arbitrary row, so the window is unswizzled and
// stored chunk-major (each 16-byte chunk of channels a column of rows): the
// 8 rows of a core matrix are 128 contiguous bytes from any start row, the
// descriptor's stride between 8-row groups 128 bytes and between the two
// chunks of a k32 step one column (`desc_plain`). A block owns 512 frames
// (a whole 10 s utterance, T' = 499, so each group's weights are read from
// L2 once an utterance): two consumer warpgroups of 256 frames, 128 int32
// accumulators a thread. Per tap a warpgroup reads 16 KB of window and 4
// KB of weight fragments from shared memory against 256 clocks of products
// (K16a's form, frames as A, reads 32 KB per 256 frames: as busy as the
// tensor cores). The consumers build the window first: x (bf16 or f32) is
// read once, divided by xs (`div_rn`: IEEE division's fast path, f32 only;
// `div_by`'s conversions to double ran at the card's conversion rate) and
// rounded half to even by the float adder (`pack_codes`), zeros outside [0,
// T); the code tensor never reaches device memory. One producer thread streams the
// taps by TMA (two taps a 128-byte swizzled box, four taps a stage, a ring
// of four), its warpgroup giving its registers to the consumers (setmaxnreg
// 40 / 232; at the launch bound's 168 ptxas spilled and serialized the
// wgmma); the next tap's fragments load while this tap's products run
// (wait_group 1). The accumulator is [channels, frames], so the epilogue
// (scale, bias, GELU and the cast, from the registers) stages 64 frames at
// a time in the freed ring and writes whole 16-byte runs of output rows.
#include "hopper.cuh"

namespace {

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

// A register A fragment (m64nNk16 bf16 or m64nNk32 int8: 16 rows x 32
// bytes) from a tile of 128-byte rows in the 128-byte swizzle (K16a's
// window, K16b's tap boxes): lane l addresses row `row` (its row of the four
// 8x8 matrices) and 16-byte chunk `chunk`.
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

// ---- K16b: int8, wgmma, the transposed form ----
constexpr int kFramesQ8 = 512;    // output frames per block
constexpr int kWgFrames = 256;    // a consumer warpgroup's: the N of m64n256k32
constexpr int kThreadsQ8 = (kConsumers + 1) * 128;  // + the producer warpgroup
constexpr int kTapBytesQ8 = kCg * kCg;  // one tap's [64 n, 64 c] int8 tile
constexpr int kTapsStageQ8 = 4;         // two TMA boxes [64 n, 128 bytes] of two taps each
constexpr int kStagesQ8 = 4;
constexpr int kStageBytesQ8 = kTapsStageQ8 * kTapBytesQ8;  // 16 KB
constexpr int kRingBytesQ8 = kStagesQ8 * kStageBytesQ8;
constexpr int kEpiFrames = 64;  // frames a warpgroup stages per epilogue step
constexpr int kBarConsumers = 1, kBarGroup = 2;  // named barriers (0 is __syncthreads)

// Window rows (frames + k - 1), padded to 4 past a multiple of 8 so that a
// column of 16-byte chunks is 64 bytes past a multiple of 128: the window's
// build then writes two columns' rows in one bank wavefront.
__host__ __device__ constexpr int window_rows_q8(int k) {
  return kFramesQ8 + k - 1 + (12 - (kFramesQ8 + k - 1) % 8) % 8;
}
// ring, window, barriers, alignment slack; the epilogue's staging (4
// buffers of 64 rows of 64 channels, padded) reuses the ring and the window
__host__ __device__ constexpr int smem_q8(int k) {
  return 1024 + kRingBytesQ8 + 4 * window_rows_q8(k) * 16 + 8 * 2 * kStagesQ8;
}

// Tap tt's A fragments (the two k32 steps of its 64 channels) from a stage:
// rows `row` of the tap's [64 n, 64 c] tile in the 128-byte swizzle, two
// taps a 128-byte row.
__device__ __forceinline__ void load_tap_w(uint32_t (&a)[2][4], uint32_t stage, int row, int hi,
                                           int tt) {
  const uint32_t box = stage + (tt / 2) * 2 * kTapBytesQ8;
#pragma unroll
  for (int kk = 0; kk < 2; ++kk) ldmatrix_a(a[kk], box, row, 4 * (tt % 2) + 2 * kk + hi);
}

// One tap's products: the weight fragments against 256 window rows from
// row address `rows` (column of chunk 0; the k32 step kk starts at column
// 2 kk).
__device__ __forceinline__ void mma_tap_q8(int (&acc)[128], const uint32_t (&a)[2][4],
                                           uint32_t rows, int cs) {
#pragma unroll
  for (int kk = 0; kk < 2; ++kk) wgmma_n256_rs(acc, a[kk], desc_plain(rows + 2 * kk * cs, cs, 128));
}

__device__ __forceinline__ void store_one(float* p, float v) { *p = v; }
__device__ __forceinline__ void store_one(bf16* p, float v) { *p = __float2bfloat16_rn(v); }

template <typename In>
__global__ void __launch_bounds__(kThreadsQ8, 1)
    posconv_q8_kernel(const In* __restrict__ x, const __grid_constant__ CUtensorMap tm_w,
                      const float* __restrict__ bias, const float* __restrict__ xs,
                      const float* __restrict__ ws, In* __restrict__ out,
                      int8_t* __restrict__ codes, int T, int k) {
  extern __shared__ unsigned char smem_raw[];
  const uint32_t raw = smem_u32(smem_raw);
  const uint32_t ring = (raw + 1023) & ~1023u;  // the swizzle pattern repeats every 1024 bytes
  unsigned char* ring_p = smem_raw + (ring - raw);
  const int rows = window_rows_q8(k), cs = rows * 16;  // cs: bytes between chunk columns
  const uint32_t win = ring + kRingBytesQ8;
  unsigned char* win_p = ring_p + kRingBytesQ8;
  const uint32_t full = win + 4 * cs, empty = full + 8 * kStagesQ8;
  const int t0 = blockIdx.x * kFramesQ8, b = blockIdx.y, g = blockIdx.z, G = gridDim.z;
  const int C = G * kCg, n_stages = k / kTapsStageQ8, pad = k / 2;
  const int tid = threadIdx.x;

  if (tid == 0) {
#pragma unroll
    for (int s = 0; s < kStagesQ8; ++s) {
      mbar_init(full + 8 * s, 1);
      mbar_init(empty + 8 * s, kConsumers);
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();

  // The launch bound leaves 168 registers a thread; the producer gives most
  // of its warpgroup's back, so the consumers' 128 accumulators, the two
  // taps' fragments and the window build fit in 232 without spills or
  // serialized wgmma.
  if (tid >= kConsumers * 128) {  // the producer warpgroup: one thread streams the taps
    asm volatile("setmaxnreg.dec.sync.aligned.u32 40;\n" ::: "memory");
    if (tid == kConsumers * 128) {
      for (int st = 0; st < n_stages; ++st) {
        const int s = st % kStagesQ8;
        mbar_wait(empty + 8 * s, ((st / kStagesQ8) & 1) ^ 1);  // a fresh ring passes
        mbar_expect_tx(full + 8 * s, kStageBytesQ8);
#pragma unroll
        for (int h = 0; h < 2; ++h)
          tma_load_2d(ring + s * kStageBytesQ8 + h * 2 * kTapBytesQ8, &tm_w,
                      (st * kTapsStageQ8 + 2 * h) * kCg, g * kCg, full + 8 * s);
      }
    }
    return;
  }

  asm volatile("setmaxnreg.inc.sync.aligned.u32 232;\n" ::: "memory");
  // The window: row p holds the codes of input frame t0 + p - k/2 (zeros
  // outside [0, T)), chunk c of its 64 channels at c * cs + p * 16. Eight
  // threads a row, eight channels each; test mode also writes the codes of
  // the block's own frames.
  const float x_scale = xs[b * G + g];
  const float rf = div_by(1.f, recip(x_scale));  // RN(1 / xs)
  const In* xb = x + static_cast<size_t>(b) * T * C + g * kCg;
  for (int i = tid; i < (kFramesQ8 + k - 1) * 8; i += kConsumers * 128) {
    const int p = i / 8, q = i % 8, t = t0 + p - pad;
    uint2 packed = make_uint2(0, 0);
    if (t >= 0 && t < T) {
      float y[8];
      load8(xb + static_cast<size_t>(t) * C + 8 * q, y);
      packed = make_uint2(
          pack_codes(div_rn(y[0], x_scale, rf), div_rn(y[1], x_scale, rf),
                     div_rn(y[2], x_scale, rf), div_rn(y[3], x_scale, rf)),
          pack_codes(div_rn(y[4], x_scale, rf), div_rn(y[5], x_scale, rf),
                     div_rn(y[6], x_scale, rf), div_rn(y[7], x_scale, rf)));
      if (codes != nullptr && p - pad < kFramesQ8 && p >= pad)
        *reinterpret_cast<uint2*>(codes + (static_cast<size_t>(b) * T + t) * C + g * kCg +
                                  8 * q) = packed;
    }
    *reinterpret_cast<uint2*>(win_p + (q / 2) * cs + p * 16 + (q % 2) * 8) = packed;
  }
  fence_async_shared();
  bar_sync(kBarConsumers, kConsumers * 128);

  const int wg = tid / 128, warp = (tid % 128) / 32, lane = tid % 32;
  const bool signals = tid % 128 == 0;  // hands the warpgroup's stages back
  // ldmatrix: lane l addresses row l % 8 of matrix l / 8 (rows + 8 for odd
  // matrices, bytes + 16 for the last two)
  const int arow = warp * 16 + (lane & 7) + ((lane >> 3) & 1) * 8, hi = lane >> 4;
  const uint32_t frames = win + wg * kWgFrames * 16;  // this warpgroup's window rows at tap 0
  int acc[128];
#pragma unroll
  for (int i = 0; i < 128; ++i) acc[i] = 0;
  uint32_t a_even[2][4], a_odd[2][4];  // the weight fragments of even and odd taps
  mbar_wait(full, 0);
  load_tap_w(a_even, ring, arow, hi, 0);
  for (int st = 0; st < n_stages; ++st) {
#pragma unroll
    for (int tt = 0; tt < kTapsStageQ8; ++tt) {
      const int j = st * kTapsStageQ8 + tt;  // frame t reads window row t - t0 + j
      wg_fence();
      if (tt % 2 == 0) {
        mma_tap_q8(acc, a_even, frames + j * 16, cs);
      } else {
        mma_tap_q8(acc, a_odd, frames + j * 16, cs);
      }
      wg_commit();
      wg_wait_one();  // tap j - 1's products are done: its fragments are free
      // every warp loaded stage st - 1's fragments before its last products
      if (tt == 0 && st > 0 && signals) mbar_arrive(empty + 8 * ((st - 1) % kStagesQ8));
      if (tt + 1 < kTapsStageQ8) {
        const uint32_t w_s = ring + (st % kStagesQ8) * kStageBytesQ8;
        if (tt % 2 == 0) {
          load_tap_w(a_odd, w_s, arow, hi, tt + 1);
        } else {
          load_tap_w(a_even, w_s, arow, hi, tt + 1);
        }
      } else if (st + 1 < n_stages) {
        const int s = (st + 1) % kStagesQ8;
        mbar_wait(full + 8 * s, ((st + 1) / kStagesQ8) & 1);
        load_tap_w(a_even, ring + s * kStageBytesQ8, arow, hi, 0);
      }
    }
  }
  wg_wait_all();
  fence_regs(acc);
  bar_sync(kBarConsumers, kConsumers * 128);  // the ring and the window are free

  // Epilogue: this thread holds channels n0 and n0 + 8 of frames 8 i + 2
  // tig + {0, 1} (i < 32). y = f32(acc) * f32(xs * ws) + bias, erf GELU,
  // one cast; staged through shared memory 64 frames at a time (two
  // buffers a warpgroup, rows padded by 16 bytes: conflict-free writes),
  // then written as whole 16-byte runs of each output row.
  const int gid = lane / 4, tig = lane % 4, n0 = warp * 16 + gid;
  float sc[2], bs[2];
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    sc[h] = __fmul_rn(x_scale, ws[g * kCg + n0 + 8 * h]);
    bs[h] = bias[g * kCg + n0 + 8 * h];
  }
  constexpr int kRowBytes = kCg * sizeof(In) + 16, kBufBytes = kEpiFrames * kRowBytes;
  constexpr int kRuns = kCg * sizeof(In) / 16;  // 16-byte runs an output row
  unsigned char* bufs = ring_p + wg * 2 * kBufBytes;
  unsigned char* orow0 = reinterpret_cast<unsigned char*>(
      out + static_cast<size_t>(b) * T * C + g * kCg);
#pragma unroll
  for (int c = 0; c < kWgFrames / kEpiFrames; ++c) {
    unsigned char* buf = bufs + (c % 2) * kBufBytes;
#pragma unroll
    for (int i = 0; i < kEpiFrames / 8; ++i)
#pragma unroll
      for (int r = 0; r < 4; ++r) {
        const int h = r / 2, f = 8 * i + 2 * tig + r % 2;
        const float y = __fmul_rn(static_cast<float>(acc[4 * (8 * c + i) + r]), sc[h]);
        store_one(reinterpret_cast<In*>(buf + f * kRowBytes) + n0 + 8 * h,
                  gelu_erf(__fadd_rn(y, bs[h])));
      }
    bar_sync(kBarGroup + wg, 128);  // the buffer is written (and the one before it read)
    const int tf = t0 + wg * kWgFrames + c * kEpiFrames;
    for (int e = tid % 128; e < kEpiFrames * kRuns; e += 128) {
      const int f = e / kRuns, q = e % kRuns;
      if (tf + f < T)
        *reinterpret_cast<uint4*>(orow0 + static_cast<size_t>(tf + f) * C * sizeof(In) + q * 16) =
            *reinterpret_cast<const uint4*>(buf + f * kRowBytes + q * 16);
    }
  }
}

// K16b's activation scales and (for posconv_quant) codes: one block per
// (group, utterance) finds the absmax of x[b, :, g*64 : g*64 + 64] over all
// T frames (the padding of the TPU's shift stack adds only zeros), xs =
// max(absmax, 1e-8) / 127 (a true division); with q given it then writes q
// = clip(rint(x / xs), -127, 127) (half to even) in x's layout [B, T, C]
// (the slice read a second time, from L2). The conv kernel takes xs alone
// and quantizes its window itself.
constexpr int kThreads = 256;
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
  if (q == nullptr) return;
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

// K16b: w int8 [G, 64, k * 64] by TMA, boxes of 64 rows x 128 bytes (two
// taps) in the 128-byte swizzle; x and out of type In.
template <typename In>
int launch_q8_as(const void* x, const void* w, const float* bias, const float* xs,
                 const float* ws, void* out, int8_t* codes, int batch, int T, int C, int k,
                 cudaStream_t stream) {
  const cuuint64_t w_dims[2] = {static_cast<cuuint64_t>(k) * kCg, static_cast<cuuint64_t>(C)};
  const cuuint64_t w_strides[1] = {static_cast<cuuint64_t>(k) * kCg};
  const cuuint32_t w_box[2] = {2 * kCg, kCg};
  CUtensorMap tm_w;
  cudaError_t err =
      swizzled_map(&tm_w, CU_TENSOR_MAP_DATA_TYPE_UINT8, 2, w, w_dims, w_strides, w_box);
  if (err == cudaSuccess)
    err = cudaFuncSetAttribute(posconv_q8_kernel<In>, cudaFuncAttributeMaxDynamicSharedMemorySize,
                               smem_q8(k));
  if (err != cudaSuccess) return static_cast<int>(err);
  const dim3 grid((T + kFramesQ8 - 1) / kFramesQ8, batch, C / kCg);
  posconv_q8_kernel<In><<<grid, kThreadsQ8, smem_q8(k), stream>>>(
      static_cast<const In*>(x), tm_w, bias, xs, ws, static_cast<In*>(out), codes, T, k);
  return static_cast<int>(cudaGetLastError());
}

int launch_q8(const void* x, const void* w, const void* bias, const void* xs, const void* ws,
              void* out, int x_is_f32, void* codes, int batch, int T, int C, int k,
              cudaStream_t stream) {
  auto launch = x_is_f32 ? launch_q8_as<float> : launch_q8_as<bf16>;
  return launch(x, w, static_cast<const float*>(bias), static_cast<const float*>(xs),
                static_cast<const float*>(ws), out, static_cast<int8_t*>(codes), batch, T, C, k,
                stream);
}

template <typename Kernel>
int occupancy(Kernel kernel, int threads, int smem, int* smem_bytes, int* blocks_per_sm) {
  *smem_bytes = smem;
  cudaError_t err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err == cudaSuccess)
    err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(blocks_per_sm, kernel, threads, smem);
  return static_cast<int>(err);
}

}  // namespace

// K16a's and K16b's (bf16 x) dynamic shared memory and blocks resident per
// SM at k taps.
extern "C" int s3_posconv_occupancy(int k, int* smem_bytes, int* blocks_per_sm) {
  return occupancy(posconv_bf16_kernel, kThreadsBf, smem_bf16(k), smem_bytes, blocks_per_sm);
}
extern "C" int s3_posconv_q8_occupancy(int k, int* smem_bytes, int* blocks_per_sm) {
  return occupancy(posconv_q8_kernel<bf16>, kThreadsQ8, smem_q8(k), smem_bytes, blocks_per_sm);
}

// K16b's activation scales xs [B, G] of x [B, T, C] (bf16 or f32) and, where
// q is given, its codes q [B, T, C] int8 (posconv_quant).
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

// x: [B, T, C], bf16 (K16a; k a multiple of 4 up to 512) or bf16 / f32
// (K16b, out_f32 for f32; k a multiple of 4 up to 1,024, with xs [B, G] from
// s3_posconv_quant and the int8 codes w and their scales ws [G, 64]); w: [G,
// 64, k * 64], bf16 (K16a) or int8 (K16b); bias f32 [C]; out [B, T, C] of
// x's type.
extern "C" int s3_posconv(const void* x, const void* w, const void* bias, const void* xs,
                          const void* ws, void* out, int q8, int out_f32, int batch, int T, int C,
                          int k, void* stream) {
  auto s = static_cast<cudaStream_t>(stream);
  if (!q8)
    return launch_bf16(x, w, static_cast<const float*>(bias), static_cast<bf16*>(out), batch, T,
                       C, k, s);
  return launch_q8(x, w, bias, xs, ws, out, out_f32, nullptr, batch, T, C, k, s);
}

// K16b's test mode: s3_posconv's K16b that also writes the int8 codes of x
// that its windows hold, codes [B, T, C].
extern "C" int s3_posconv_q8_codes(const void* x, const void* w, const void* bias, const void* xs,
                                   const void* ws, void* out, int out_f32, void* codes, int batch,
                                   int T, int C, int k, void* stream) {
  return launch_q8(x, w, bias, xs, ws, out, out_f32, codes, batch, T, C, k,
                   static_cast<cudaStream_t>(stream));
}
