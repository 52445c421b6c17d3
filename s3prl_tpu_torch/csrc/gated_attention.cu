// Masked attention on Hopper (sm_90a) in f32 on bf16 q, k, v with head dim
// 64, with or without WavLM's gated relative-position bias (pos_bias [H, T,
// T] in f32 or bf16, the last axis contiguous, rows `bias_ld` elements
// apart; shared by the utterances; gate [B, H, T] f32):
//   s_k = q_t.k_k [+ gate[b, h, t] * pos_bias[h, t, k]]  for k < kv_len[b],
//         `masked` otherwise
//   out[b, h, t] = sum_k p_k v_k / max(sum_k p_k, l_floor),  p_k = exp(s_k - m)
//
// One kernel for eight Pallas kernels (s3prl_tpu/kernels/flash_attention.py),
// in two layouts.
//
// Split heads: q (pre-scaled by Dh^-0.5), k, v and out [B, H, T, 64]; P.V
// keeps P in f32 as three bf16 parts (below):
// - K9 `gated_bias_attention` (pallas_call :105, cell `_attn_kernel` :59-89),
//   the whole-T cell for T <= MAX_KERNEL_T: masked = -1e9, no floor
//   (l_floor = 0);
// - K10 `_gated_online_flash_kernel` (pallas_call :963, cell
//   `_gated_online_kernel` :901-945), K-blocked beyond it: masked = -1e30,
//   l_floor = 1e-30;
// - K17 `flash_attention` (pallas_call :1020, cell `_attn_kernel_nobias`
//   :994-1011), the no-bias instantiation (kGated = false: no gate or bias
//   is read): masked = -1e9, no floor;
// - K8 `online_flash_attention` (pallas_call :867, cell `_online_kernel`
//   :814-854), K17's instantiation with K10's constants: masked = -1e30,
//   l_floor = 1e-30.
// On the TPU they differ because a whole [T, T] score tile must fit VMEM;
// here all are K-blocked, so they share one kernel and differ in the two
// constants and the template flag.
//
// Packed (kPacked): q, k and v are the columns of head h of the fused,
// unscaled [B, T, 3C] QKV buffer (0, C and 2C on), out is [B, T, C] in bf16
// or f32, and the math is the cells' of K7 `fused_qkv_attention`
// (pallas_call :210, cell :159-197), of the attention step of K1
// `fused_attention_block` (:633, :564-588) and K4
// `fused_attention_block_bf16` (:772, :733-751), and, with the f32
// output, of K6 `fused_qkv_attention_outproj` (:312), whose heads are
// concatenated unrounded before its context quantization:
//   s_k = q_t.k_k * Dh^-0.5 - 1e9 * (k >= kv_len[b]),  keys past T dropped,
//   out = sum_k bf16(p_k) v_k / sum_k p_k,
// the additive -1e9 of the cells, and P cast once to bf16 for one P.V
// product (the cells cast the normalised P; here P <= 1 is cast and l
// divides at the store). A row with kv_len = 0 (an utterance of no frame
// under the conv length rule) runs every key tile of T with every key
// masked, which gives it a near-uniform row, as the plain version
// (`attention_reference`) does.
// Packed and gated, with the f32 output: the attention of K11
// `gated_bias_attention_outproj` (pallas_call :423, cell :360-403), whose
// scores are (q.k * Dh^-0.5 + gate[b, h, t] * pos_bias[h, t, k]) - 1e9 *
// (k >= kv_len[b]) in the cell's order (:379-385: the scale, then the
// product, then the sums), with an f32 bias.
//
// Design: one block is one warpgroup (128 threads) on 64 queries of one
// (utterance, head); key tiles of 64 stream through a ring of three
// stages, each holding the K tile, the V tile and the bias tile [64
// queries, 64 keys]. K, V (and Q, once) come by TMA in the 128-byte swizzle
// that wgmma reads, from a [B*H, T, 64] tensor map (split heads) or one [B,
// T, 3C] map whose 64-column boxes at h * 64, C + h * 64 and 2C + h * 64
// are head h's q, k and v (packed); either map zero-fills the rows past T
// of each head or utterance, so no read crosses into the next. The bias
// tile comes by cp.async (16-byte granules, or 4-byte ones for f32 rows
// that are not 16-byte aligned), completing on the same stage mbarrier
// (cp.async.mbarrier.arrive.noinc). At the top of tile kt the block issues
// the loads of tile kt + 2 into the stage tile kt - 1 freed, so two tiles of
// K, V and bias are in flight while one computes.
//
// S = Q K^T is four wgmma m64n64k16 (bf16 in, f32 accumulate; a product of
// two bf16 values is exact in f32). The scores stay in the accumulator's
// registers: a thread holds two adjacent keys of rows r and r + 8 in each
// 8-key chunk, so it reads a float2 (or bf16x2) of the staged bias tile,
// adds gate * bias (the product first, then the sum, __fmul_rn/__fadd_rn:
// no contraction, as the cell writes it), masks, and takes the row max and
// sum by shuffles among the 4 threads of a row. The running output is
// rescaled in registers. With three parts P.V stays exact in f32: each
// probability is split into three bf16 parts (p = hi + mid + lo, two at a
// time with cvt.rn.bf16x2.f32), which are the register A operands of twelve
// wgmma m64n64k16 against V in shared memory (transposed B: V is [keys,
// Dh]), the small parts first; with one part (packed) P is hi alone, four
// products. The accumulator's layout of S is the A operand's layout of P,
// so nothing goes through shared memory between the products.
//
// Block order: with a bias (split heads or packed) the utterance runs
// fastest (blockIdx.x = b), so the B blocks that read the same [64, T] rows
// of pos_bias are launched together and hit L2 (the TPU kernels'
// batch-innermost grids, :65-69, :426); otherwise the bias would come from
// device memory B times (an f32 bias at T = 1,499 is 144 MB, beyond L2).
// Without one, packed runs the query tiles fastest, so the blocks of one
// (utterance, head) share its K and V in L2.
//
// Masking: the softmax sees `masked` for keys at or past kv_len and -inf
// for keys past T. A key tile wholly past kv_len contributes exactly 0
// (exp2 of masked - m underflows once a valid score has set m), so those
// tiles are not loaded. A row with kv_len = 0 has no valid score: it runs
// every key tile of T, each of its T keys scores `masked` (split heads) or
// s + masked (packed), so the row is the (near-)uniform mean of the T
// values, as the cells' whole-row softmax and the plain versions give it;
// skipping the tiles would leave l = 0 (0 / 0 without a floor).
//
// Bound: at WavLM-Large's shapes the bytes (q, k, v, out and the bias: 288
// MB in bf16 at T = 2999) take less time than the tensor-core issue of the
// four 64-deep products per tile (S, and P.V three times) plus the
// exponentials on the special-function units; without the bias, and with
// one P.V product (packed), the products and the exponentials bound it.
#include "hopper.cuh"

namespace {

using namespace s3;

constexpr int kDh = 64;
constexpr int kBQ = 64, kBKV = 64;
constexpr int kThreads = 128;  // one warpgroup
constexpr int kStages = 3;
constexpr int kTileBytes = kBKV * kDh * 2;  // a 64 x 64 bf16 tile: 64 swizzled rows of 128 bytes
constexpr int kLdb = kBKV + 8;              // bias row stride in shared memory (no bank conflicts)

template <bool kGated, typename BiasT>
struct Smem {  // Q, then kStages x (K, V, bias), then the barriers: Q's and one per stage
  static constexpr int kBiasBytes = kGated ? kBQ * kLdb * static_cast<int>(sizeof(BiasT)) : 0;
  static constexpr int kStageBytes = 2 * kTileBytes + kBiasBytes;  // multiples of 1024
  static constexpr int kBars = kTileBytes + kStages * kStageBytes;
  static constexpr int kBytes = kBars + 8 * (1 + kStages) + 1024;  // + the alignment slack
};

__device__ __forceinline__ float2 bias2(const float* p) {
  return *reinterpret_cast<const float2*>(p);
}
__device__ __forceinline__ float2 bias2(const bf16* p) {
  return __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(p));
}

__device__ __forceinline__ void store2(bf16* p, float x, float y) {
  *reinterpret_cast<__nv_bfloat162*>(p) = __floats2bfloat162_rn(x, y);
}
__device__ __forceinline__ void store2(float* p, float x, float y) {
  *reinterpret_cast<float2*>(p) = make_float2(x, y);
}

__device__ __forceinline__ uint32_t pack_bf16x2(float lo_col, float hi_col) {
  const __nv_bfloat162 v = __floats2bfloat162_rn(lo_col, hi_col);  // cvt.rn.bf16x2.f32
  return *reinterpret_cast<const uint32_t*>(&v);
}
__device__ __forceinline__ float2 unpack_bf16x2(uint32_t v) {
  return __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(&v));
}

// The bias tile [64 queries, 64 keys] from rows q0.., keys k0.. into
// shared memory (row stride kLdb); entries past T are zero-filled, never read
// from device memory.
template <typename BiasT>
__device__ __forceinline__ void load_bias(uint32_t dst, const BiasT* bias_h, int ld, bool vec16,
                                          int q0, int k0, int T, int tid) {
  constexpr int kSize = sizeof(BiasT), kVec = 16 / kSize;
  if (sizeof(BiasT) == 2 || vec16) {
#pragma unroll
    for (int i = tid; i < kBQ * (kBKV / kVec); i += kThreads) {
      const int r = i / (kBKV / kVec), c = (i % (kBKV / kVec)) * kVec;
      const int t = q0 + r, k = k0 + c;
      const int n = t < T && k < T ? min(kVec, T - k) * kSize : 0;
      const BiasT* src = n ? bias_h + static_cast<size_t>(t) * ld + k : bias_h;
      cp_async16_zfill(dst + (r * kLdb + c) * kSize, src, n);
    }
  } else {  // f32 rows that are not 16-byte aligned (an unpadded [H, T, T] at odd T)
#pragma unroll 8
    for (int i = tid; i < kBQ * kBKV; i += kThreads) {
      const int r = i / kBKV, c = i % kBKV;
      const int t = q0 + r, k = k0 + c;
      const bool ok = t < T && k < T;
      const BiasT* src = ok ? bias_h + static_cast<size_t>(t) * ld + k : bias_h;
      cp_async4_zfill(dst + (r * kLdb + c) * kSize, src, ok ? kSize : 0);
    }
  }
}

// kPacked: q, k, v are head h's columns of the fused [B, T, 3C] buffer and
// out is [B, T, C] (K7's math, above); otherwise [B, H, T, 64] each. kParts:
// the bf16 parts of P (3: exact in f32; 1: P cast once to bf16).
template <bool kGated, typename BiasT, bool kPacked, int kParts, typename OutT>
__global__ void __launch_bounds__(kThreads)
    gated_attention_kernel(const __grid_constant__ CUtensorMap tm_q,
                           const __grid_constant__ CUtensorMap tm_k,
                           const __grid_constant__ CUtensorMap tm_v,
                           const BiasT* __restrict__ pos_bias, int bias_ld, int vec16,
                           const float* __restrict__ gate, const int* __restrict__ kv_lens,
                           OutT* __restrict__ out, int H, int T, float masked, float l_floor,
                           float scale) {
  static_assert(kParts == 1 || kParts == 3, "P in one or three bf16 parts");
  using L = Smem<kGated, BiasT>;
  extern __shared__ unsigned char smem_raw[];
  const uint32_t raw = smem_u32(smem_raw);
  const uint32_t base = (raw + 1023) & ~1023u;  // the swizzle pattern repeats every 1024 bytes
  const unsigned char* smem = smem_raw + (base - raw);
  const uint32_t q_s = base, bars = base + L::kBars;  // bars: Q's, then one per stage
  auto k_s = [&](int st) { return base + kTileBytes + st * L::kStageBytes; };

  // with a bias or split heads: blocks (utterance, query tile, head);
  // packed without a bias: (query tile, head, utterance)
  constexpr bool kBatchFastest = kGated || !kPacked;
  const int b = kBatchFastest ? blockIdx.x : blockIdx.z;
  const int q0 = (kBatchFastest ? blockIdx.y : blockIdx.x) * kBQ;
  const int h = kBatchFastest ? blockIdx.z : blockIdx.y;
  const int bh = b * H + h, C = H * kDh;
  const size_t head = static_cast<size_t>(bh) * T;
  // the boxes' coordinates: slab z, and the columns of q, k and v in it
  const int z = kPacked ? b : bh;
  const int col_q = kPacked ? h * kDh : 0, col_k = kPacked ? C + h * kDh : 0,
            col_v = kPacked ? 2 * C + h * kDh : 0;
  const BiasT* bias_h = kGated ? pos_bias + static_cast<size_t>(h) * T * bias_ld : nullptr;
  const int tid = threadIdx.x, warp = tid / 32, lane = tid % 32;
  const int kv_len = min(max(kv_lens[b], 0), T);
  // a row with kv_len = 0 runs every key tile of T, every key masked
  const int n_tiles = ((kv_len == 0 ? T : kv_len) + kBKV - 1) / kBKV;

  if (tid == 0) {
    mbar_init(bars, 1);
#pragma unroll
    for (int st = 0; st < kStages; ++st) mbar_init(bars + 8 * (1 + st), kGated ? kThreads + 1 : 1);
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();

  // Tile kt's K and V by TMA (thread 0) and its bias by cp.async (every
  // thread), all completing on the stage barrier.
  auto issue = [&](int kt) {
    const int st = kt % kStages;
    const uint32_t full = bars + 8 * (1 + st);
    if (tid == 0) {
      mbar_expect_tx(full, 2 * kTileBytes);
      tma_load_3d(k_s(st), &tm_k, col_k, kt * kBKV, z, full);
      tma_load_3d(k_s(st) + kTileBytes, &tm_v, col_v, kt * kBKV, z, full);
    }
    if constexpr (kGated) {
      load_bias(k_s(st) + 2 * kTileBytes, bias_h, bias_ld, vec16, q0, kt * kBKV, T, tid);
      cp_async_arrive(full);
    }
  };
  if (tid == 0) {
    mbar_expect_tx(bars, kTileBytes);
    tma_load_3d(q_s, &tm_q, col_q, q0, z, bars);
  }
  for (int kt = 0; kt < min(n_tiles, kStages - 1); ++kt) issue(kt);

  // This thread's rows of the tile (the accumulator layout of m64nNk16):
  // rw and rw + 8, keys 8c + cq and 8c + cq + 1 of each 8-key chunk c.
  const int rw = warp * 16 + lane / 4, cq = 2 * (lane % 4);
  float g0 = 0.f, g1 = 0.f;
  if (kGated) {
    if (q0 + rw < T) g0 = gate[head + q0 + rw];
    if (q0 + rw + 8 < T) g1 = gate[head + q0 + rw + 8];
  }
  float o[32];
#pragma unroll
  for (int i = 0; i < 32; ++i) o[i] = 0.f;
  // packed: a masked score is s - 1e9, which can lie below -1e9, and keys
  // past T are -inf, so the running max starts at -inf
  const float m_init = kPacked ? -INFINITY : masked;
  float m0 = m_init, m1 = m_init, l0 = 0.f, l1 = 0.f;
  mbar_wait(bars, 0);  // Q

  for (int kt = 0; kt < n_tiles; ++kt) {
    const int st = kt % kStages, k0 = kt * kBKV;
    __syncthreads();  // every thread is done with tile kt - 1, whose stage tile kt + 2 takes
    if (kt + kStages - 1 < n_tiles) issue(kt + kStages - 1);
    mbar_wait(bars + 8 * (1 + st), (kt / kStages) & 1);

    // S = Q K^T
    float s[32];
#pragma unroll
    for (int i = 0; i < 32; ++i) s[i] = 0.f;
    fence_regs(s);
    wg_fence();
#pragma unroll
    for (int kk = 0; kk < kDh / 16; ++kk)
      wgmma_ss(s, desc128(q_s + 32 * kk), desc128(k_s(st) + 32 * kk), kk > 0);
    wg_commit();
    wg_wait_all();
    fence_regs(s);

    // [* Dh^-0.5 (packed)] + gate * bias, then the key mask (only the last
    // tile can hold keys past kv_len, but for a row with kv_len = 0)
    if constexpr (kPacked && kGated) {  // the scale rounds before the bias is added
#pragma unroll
      for (int i = 0; i < 32; ++i) s[i] = __fmul_rn(s[i], scale);
    } else if constexpr (kPacked) {
#pragma unroll
      for (int i = 0; i < 32; ++i) s[i] *= scale;
    }
    if constexpr (kGated) {
      const BiasT* bt = reinterpret_cast<const BiasT*>(smem + (k_s(st) - base) + 2 * kTileBytes);
#pragma unroll
      for (int c = 0; c < 8; ++c) {
        const float2 b0 = bias2(bt + rw * kLdb + 8 * c + cq);
        const float2 b1 = bias2(bt + (rw + 8) * kLdb + 8 * c + cq);
        s[4 * c + 0] = __fadd_rn(s[4 * c + 0], __fmul_rn(g0, b0.x));
        s[4 * c + 1] = __fadd_rn(s[4 * c + 1], __fmul_rn(g0, b0.y));
        s[4 * c + 2] = __fadd_rn(s[4 * c + 2], __fmul_rn(g1, b1.x));
        s[4 * c + 3] = __fadd_rn(s[4 * c + 3], __fmul_rn(g1, b1.y));
      }
    }
    if (k0 + kBKV > kv_len) {
#pragma unroll
      for (int i = 0; i < 32; ++i) {
        const int key = k0 + 8 * (i / 4) + cq + (i % 2);
        if (key >= kv_len) s[i] = key >= T ? -INFINITY : kPacked ? s[i] + masked : masked;
      }
    }

    // online softmax on rows rw (even pairs) and rw + 8 (odd pairs), a row's
    // 64 keys spread over the 4 threads lane / 4 shares
    float mx0 = m_init, mx1 = m_init;
#pragma unroll
    for (int c = 0; c < 8; ++c) {
      mx0 = fmaxf(mx0, fmaxf(s[4 * c], s[4 * c + 1]));
      mx1 = fmaxf(mx1, fmaxf(s[4 * c + 2], s[4 * c + 3]));
    }
#pragma unroll
    for (int x = 1; x <= 2; x <<= 1) {
      mx0 = fmaxf(mx0, __shfl_xor_sync(0xffffffffu, mx0, x));
      mx1 = fmaxf(mx1, __shfl_xor_sync(0xffffffffu, mx1, x));
    }
    const float mn0 = fmaxf(m0, mx0), mn1 = fmaxf(m1, mx1);
    const float a0 = exp2f((m0 - mn0) * s3::kLog2e), a1 = exp2f((m1 - mn1) * s3::kLog2e);
    float ps0 = 0.f, ps1 = 0.f;
#pragma unroll
    for (int c = 0; c < 8; ++c) {
      s[4 * c + 0] = exp2f((s[4 * c + 0] - mn0) * s3::kLog2e);
      s[4 * c + 1] = exp2f((s[4 * c + 1] - mn0) * s3::kLog2e);
      s[4 * c + 2] = exp2f((s[4 * c + 2] - mn1) * s3::kLog2e);
      s[4 * c + 3] = exp2f((s[4 * c + 3] - mn1) * s3::kLog2e);
      ps0 += s[4 * c] + s[4 * c + 1];
      ps1 += s[4 * c + 2] + s[4 * c + 3];
    }
#pragma unroll
    for (int x = 1; x <= 2; x <<= 1) {
      ps0 += __shfl_xor_sync(0xffffffffu, ps0, x);
      ps1 += __shfl_xor_sync(0xffffffffu, ps1, x);
    }
    l0 = l0 * a0 + ps0;
    l1 = l1 * a1 + ps1;
    m0 = mn0;
    m1 = mn1;
#pragma unroll
    for (int c = 0; c < 8; ++c) {
      o[4 * c + 0] *= a0;
      o[4 * c + 1] *= a0;
      o[4 * c + 2] *= a1;
      o[4 * c + 3] *= a1;
    }

    // p = hi [+ mid + lo] in bf16 (each remainder exact in f32). Key step j
    // (keys 16j..16j+15) is the A fragment {rw: 2j, rw+8: 2j, rw: 2j+1,
    // rw+8: 2j+1} of chunks, i.e. accumulator registers 8j..8j+7 in order.
    uint32_t hi[4][4], mid[4][4], lo[4][4];
#pragma unroll
    for (int j = 0; j < 4; ++j) {
#pragma unroll
      for (int r = 0; r < 4; ++r) {
        const float x = s[8 * j + 2 * r], y = s[8 * j + 2 * r + 1];
        hi[j][r] = pack_bf16x2(x, y);
        if constexpr (kParts == 3) {
          const float2 h2 = unpack_bf16x2(hi[j][r]);
          const float rx = x - h2.x, ry = y - h2.y;
          mid[j][r] = pack_bf16x2(rx, ry);
          const float2 m2 = unpack_bf16x2(mid[j][r]);
          lo[j][r] = pack_bf16x2(rx - m2.x, ry - m2.y);
        }
      }
    }

    // O += [lo + mid +] hi V
    fence_regs(o);
    wg_fence();
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const uint64_t dv = desc128(k_s(st) + kTileBytes + j * 16 * 128);
      if constexpr (kParts == 3) {
        wgmma_rs<1>(o, lo[j], dv);
        wgmma_rs<1>(o, mid[j], dv);
      }
      wgmma_rs<1>(o, hi[j], dv);
    }
    wg_commit();
    wg_wait_all();
    fence_regs(o);
  }

  // normalise and store this thread's two rows
  const float d0 = fmaxf(l0, l_floor), d1 = fmaxf(l1, l_floor);
#pragma unroll
  for (int half = 0; half < 2; ++half) {
    const int t = q0 + rw + 8 * half;
    if (t >= T) continue;
    const float d = half ? d1 : d0;
    OutT* orow = kPacked ? out + (static_cast<size_t>(b) * T + t) * C + h * kDh + cq
                         : out + (head + t) * kDh + cq;
#pragma unroll
    for (int c = 0; c < 8; ++c)
      store2(orow + 8 * c, o[4 * c + 2 * half] / d, o[4 * c + 2 * half + 1] / d);
  }
}

// [Z, T, width] bf16, rows of `width` elements: a contiguous [B, H, T, 64]
// (width 64, Z = B*H) or the fused [B, T, 3C] (width 3C, Z = B); boxes of
// 64 rows by 64 columns, the 128-byte swizzle, rows past T zero-filled.
cudaError_t rows_map(CUtensorMap* map, const void* x, int width, int T, int Z) {
  const cuuint64_t dims[3] = {static_cast<cuuint64_t>(width), static_cast<cuuint64_t>(T),
                              static_cast<cuuint64_t>(Z)};
  const cuuint64_t strides[2] = {static_cast<cuuint64_t>(width) * 2,
                                 static_cast<cuuint64_t>(T) * width * 2};
  const cuuint32_t box[3] = {kDh, kBKV, 1};
  return swizzled_map(map, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 3, x, dims, strides, box);
}

// Packed: q = k = v = the fused [B, T, 3C] buffer, out [B, T, C].
template <bool kGated, typename BiasT, bool kPacked, int kParts, typename OutT>
int launch(const void* q, const void* k, const void* v, const void* pos_bias, int bias_ld,
           const void* gate, const void* kv_lens, void* out, int batch, int H, int T,
           float masked, float l_floor, float scale, void* stream) {
  using L = Smem<kGated, BiasT>;
  const int width = kPacked ? 3 * H * kDh : kDh, Z = kPacked ? batch : batch * H;
  CUtensorMap tm_q, tm_k, tm_v;
  cudaError_t err = rows_map(&tm_q, q, width, T, Z);
  if (err == cudaSuccess) err = rows_map(&tm_k, k, width, T, Z);
  if (err == cudaSuccess) err = rows_map(&tm_v, v, width, T, Z);
  if (err != cudaSuccess) return static_cast<int>(err);
  const int vec16 = sizeof(BiasT) == 2 ||
                    (bias_ld % 4 == 0 && reinterpret_cast<uintptr_t>(pos_bias) % 16 == 0);
  auto kernel = gated_attention_kernel<kGated, BiasT, kPacked, kParts, OutT>;
  err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, L::kBytes);
  if (err != cudaSuccess) return static_cast<int>(err);
  const int q_tiles = (T + kBQ - 1) / kBQ;
  const dim3 grid = kGated || !kPacked ? dim3(batch, q_tiles, H) : dim3(q_tiles, H, batch);
  kernel<<<grid, kThreads, L::kBytes, static_cast<cudaStream_t>(stream)>>>(
      tm_q, tm_k, tm_v, static_cast<const BiasT*>(pos_bias), bias_ld, vec16,
      static_cast<const float*>(gate), static_cast<const int*>(kv_lens), static_cast<OutT*>(out),
      H, T, masked, l_floor, scale);
  return static_cast<int>(cudaGetLastError());
}

template <bool kGated, typename BiasT, bool kPacked, int kParts, typename OutT>
int occupancy(int* smem_bytes, int* blocks_per_sm) {
  using L = Smem<kGated, BiasT>;
  auto kernel = gated_attention_kernel<kGated, BiasT, kPacked, kParts, OutT>;
  *smem_bytes = L::kBytes;
  cudaError_t err =
      cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, L::kBytes);
  if (err == cudaSuccess)
    err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(blocks_per_sm, kernel, kThreads, L::kBytes);
  return static_cast<int>(err);
}

}  // namespace

// Dynamic shared memory of a block and blocks resident per SM of the
// instantiation `kind` (0: no bias, 1: bf16 bias, 2: f32 bias, all split
// heads in three parts; 3: packed, bf16 out; 4: packed, f32 out; 5: packed,
// f32 bias, f32 out).
extern "C" int s3_gated_attention_occupancy(int kind, int* smem_bytes, int* blocks_per_sm) {
  switch (kind) {
    case 0: return occupancy<false, bf16, false, 3, bf16>(smem_bytes, blocks_per_sm);
    case 1: return occupancy<true, bf16, false, 3, bf16>(smem_bytes, blocks_per_sm);
    case 2: return occupancy<true, float, false, 3, bf16>(smem_bytes, blocks_per_sm);
    case 3: return occupancy<false, bf16, true, 1, bf16>(smem_bytes, blocks_per_sm);
    case 4: return occupancy<false, bf16, true, 1, float>(smem_bytes, blocks_per_sm);
    case 5: return occupancy<true, float, true, 1, float>(smem_bytes, blocks_per_sm);
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}

// pos_bias: f32 (bias_f32 = 1) or bf16 [H, T, T], rows bias_ld elements apart
// (bf16: a multiple of 8, 16-byte aligned).
extern "C" int s3_gated_attention(const void* q, const void* k, const void* v,
                                  const void* pos_bias, int bias_f32, int bias_ld,
                                  const void* gate, const void* kv_lens, void* out, int batch,
                                  int H, int T, float masked, float l_floor, void* stream) {
  if (bias_f32)
    return launch<true, float, false, 3, bf16>(q, k, v, pos_bias, bias_ld, gate, kv_lens, out,
                                               batch, H, T, masked, l_floor, 0.f, stream);
  return launch<true, bf16, false, 3, bf16>(q, k, v, pos_bias, bias_ld, gate, kv_lens, out, batch,
                                            H, T, masked, l_floor, 0.f, stream);
}

// K17: no bias, the -1e9 mask, no floor.
extern "C" int s3_flash_attention(const void* q, const void* k, const void* v,
                                  const void* kv_lens, void* out, int batch, int H, int T,
                                  void* stream) {
  return launch<false, bf16, false, 3, bf16>(q, k, v, nullptr, 0, nullptr, kv_lens, out, batch, H,
                                             T, -1e9f, 0.f, 0.f, stream);
}

// K8: no bias, the -1e30 mask, the denominator max(l, 1e-30).
extern "C" int s3_online_attention(const void* q, const void* k, const void* v,
                                   const void* kv_lens, void* out, int batch, int H, int T,
                                   void* stream) {
  return launch<false, bf16, false, 3, bf16>(q, k, v, nullptr, 0, nullptr, kv_lens, out, batch, H,
                                             T, -1e30f, 1e-30f, 0.f, stream);
}

// K7's math on the fused qkv [B, T, 3C] (C = 64 H, unscaled): scores times
// `scale`, the additive -1e9 past kv_len, P in one bf16 part; out [B, T, C]
// in bf16, or f32 (out_f32 = 1).
extern "C" int s3_qkv_attention(const void* qkv, const void* kv_lens, void* out, int batch, int T,
                                int H, float scale, int out_f32, void* stream) {
  if (out_f32)
    return launch<false, bf16, true, 1, float>(qkv, qkv, qkv, nullptr, 0, nullptr, kv_lens, out,
                                               batch, H, T, -1e9f, 0.f, scale, stream);
  return launch<false, bf16, true, 1, bf16>(qkv, qkv, qkv, nullptr, 0, nullptr, kv_lens, out,
                                            batch, H, T, -1e9f, 0.f, scale, stream);
}

// K11's attention on the fused qkv [B, T, 3C] (C = 64 H, unscaled): scores
// times `scale` plus gate * pos_bias (pos_bias f32 [H, T, T], rows bias_ld
// elements apart; gate [B, H, T] f32), the additive -1e9 past kv_len, P in
// one bf16 part; out [B, T, C] f32.
extern "C" int s3_qkv_attention_gated(const void* qkv, const void* kv_lens, const void* pos_bias,
                                      int bias_ld, const void* gate, void* out, int batch, int T,
                                      int H, float scale, void* stream) {
  return launch<true, float, true, 1, float>(qkv, qkv, qkv, pos_bias, bias_ld, gate, kv_lens, out,
                                             batch, H, T, -1e9f, 0.f, scale, stream);
}
