// int8 x int8 -> exact int32 GEMM on Hopper's tensor cores (wgmma, TMA),
// with the dequantizing epilogues of the int8 whole-block kernels:
//   acc[m, n] = sum_k a[m, k] * w[n, k]
// a [M, K] int8 with row stride lda, in row groups: row m = (g, r) = (m /
// a_rows, m % a_rows) starts at a + g * a_gstride + r * lda (one group of M
// rows is a plain matrix; a conv tap reads its stride-2 rows straight from
// x [B, T, C] as B groups of T' rows with lda = 2C), w [N, K] int8 with row
// stride ldw (nn.Linear layout; a K range of a wider matrix is a pointer
// offset plus its row stride), then per output element one of
//   kRaw     out int32 = acc;
//   kQkv     out bf16 = bf16(bf16(bf16(acc) * bf16(rs[m] * cs[n])) + bf16(bias[n]));
//   kLinear  v = f32(acc) * rs[m] * cs[n]; [v = acc_in[m, n] + v]; [v = v + bias[n]];
//            [v = gelu_tanh(v)]; [v = v + f32(res[m, n])]; out f32 or bf16.
// rs are per-row activation scales, cs per-output-channel weight scales.
//
// Serves every int8 product that the Pallas kernels compute in their own
// bodies:
//   - `fused_attention_block` (s3prl_tpu/kernels/flash_attention.py:664,
//     pallas_call at :633): the QKV GEMM with its three bf16 roundings
//     (kQkv, :537-544) and the out-proj with scale, bias and residual in f32
//     (kLinear, :615-621; f32 out when the postnorm LN follows); K6's
//     out-proj (:413) and K11's (:629);
//   - `fused_int8_ffn` (s3prl_tpu/kernels/ffn.py:160, pallas_call at :129):
//     fc1 with scale, bias and tanh GELU in f32 (kLinear + gelu, :94-99), and
//     fc2 once per FFN chunk, each adding its dequantized sum to the f32
//     running output (kLinear + acc_in, :101-105); the last chunk adds b2 and
//     x (:106-109); K12 `fused_int8_linear` (:238);
//   - `fused_int8_conv_ln_gelu` (conv_frontend.py:325, pallas_call at :370):
//     one launch per conv tap, each adding (f32(acc) * rs) * ws to the f32
//     sum of the taps before it in tap order (kLinear + acc_in, :219-235);
//     ln_gelu.cu then normalises and requantizes.
// int32 sums are exact in any order, so kRaw equals torch._int_mm bit for
// bit. Every f32 operation of the epilogues is an explicit __fmul_rn /
// __fadd_rn, so none is contracted into an FMA and each rounds in the order
// the Pallas kernel writes.
//
// Bound: tensor-core throughput at the main path's shapes (M = 15,968 rows
// at B=32, K = 1024 or 2048 per chunk, N up to 4096: 134 GOP for fc1).
// Design: a persistent grid (one block per SM) walks the output tiles of 128
// rows x 256 columns, columns fastest, so the blocks in flight share their A
// rows and the weights stay in L2. One producer thread keeps a ring of four
// stages full by TMA: each stage is a 128 x 128-byte A box and a 256 x
// 128-byte W box in the 128-byte swizzle that wgmma reads, from tensor maps
// whose bounds zero-fill the ragged M, N and K edges. A's map is 3-D (K, rows
// of a group, groups), so a row-group view is tiled group by group and no box
// crosses from one utterance into the next; a column range is the map's
// stride. Two consumer warpgroups each own 64 rows of the tile: per stage four
// wgmma m64n256k32 (s8 x s8 -> s32) accumulate in 128 registers a thread;
// each stage is handed back to the producer once the products after it are
// issued and its own have completed (wait_group 1); the producer's
// warpgroup hands its registers to them (setmaxnreg). The producer runs ahead
// into the next tile while the consumers apply the epilogue straight from the
// accumulator registers, so the next tile's first stages are loaded by the
// time its products start. The epilogue goes 8 chunks at a time, each
// batch's loads (scales, bias, the f32 sum it adds to, the residual) issued
// before its stores. What holds it back (PERF.md): the epilogue does not
// overlap the products (both warpgroups run it at once), and the tiles'
// reads from L2 (784 MB for K2's fc1) are near L2's rate; a ping-pong
// schedule (each warpgroup on tiles of its own, main loops in turn) and
// cluster multicast are the next steps.
#include "hopper.cuh"

namespace {

using namespace s3;

constexpr int kBM = 128, kBN = 256, kBK = 128;  // tile rows, columns, K bytes a stage
constexpr int kStages = 4;
constexpr int kConsumers = 2;                     // warpgroups of 64 rows
constexpr int kThreads = (kConsumers + 1) * 128;  // + the producer warpgroup
constexpr int kATile = kBM * kBK, kWTile = kBN * kBK;
constexpr int kStageBytes = kATile + kWTile;  // 48 KB, a multiple of 1024
constexpr int kSmemBytes = kStages * kStageBytes + 2 * kStages * 8 + 1024;  // + alignment slack

enum Mode { kRaw = 0, kQkv = 1, kLinear = 2 };

struct Epilogue {
  const float* rs;
  const float* cs;
  const float* bias;    // null: no bias
  const float* acc_in;  // [M, N] f32 or null; may alias out
  const bf16* res;      // [M, N] bf16 or null
  void* out;            // [M, N]
  int gelu, out_f32;
};

#define S3_ACC128                                                                           \
  "{"                                                                                       \
  "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "                  \
  "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31, "        \
  "%32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47, "        \
  "%48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63, "        \
  "%64, %65, %66, %67, %68, %69, %70, %71, %72, %73, %74, %75, %76, %77, %78, %79, "        \
  "%80, %81, %82, %83, %84, %85, %86, %87, %88, %89, %90, %91, %92, %93, %94, %95, "        \
  "%96, %97, %98, %99, %100, %101, %102, %103, %104, %105, %106, %107, %108, %109, %110, " \
  "%111, %112, %113, %114, %115, %116, %117, %118, %119, %120, %121, %122, %123, %124, "    \
  "%125, %126, %127}"
#define S3_D8(d, i)                                                                    \
  "+r"(d[i]), "+r"(d[i + 1]), "+r"(d[i + 2]), "+r"(d[i + 3]), "+r"(d[i + 4]),        \
      "+r"(d[i + 5]), "+r"(d[i + 6]), "+r"(d[i + 7])
#define S3_OUT128(d)                                                                      \
  S3_D8(d, 0), S3_D8(d, 8), S3_D8(d, 16), S3_D8(d, 24), S3_D8(d, 32), S3_D8(d, 40),     \
      S3_D8(d, 48), S3_D8(d, 56), S3_D8(d, 64), S3_D8(d, 72), S3_D8(d, 80), S3_D8(d, 88), \
      S3_D8(d, 96), S3_D8(d, 104), S3_D8(d, 112), S3_D8(d, 120)

// d (+)= A B: A [64 rows, 32] and B [256 columns, 32], both K-major int8 in
// shared memory, exact int32 sums
__device__ __forceinline__ void wgmma_s8(int (&d)[128], uint64_t a, uint64_t b, int accumulate) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %130, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n256k32.s32.s8.s8 " S3_ACC128 ", %128, %129, p;\n}\n"
      : S3_OUT128(d)
      : "l"(a), "l"(b), "r"(accumulate));
}

__device__ __forceinline__ float bf16_round(float v) {
  return __bfloat162float(__float2bfloat16_rn(v));
}

constexpr int kBatch = 8;  // 8-column chunks whose loads are issued before their stores

// One row's batch of kBatch chunks of this thread's fragment: columns n0 +
// 8i and n0 + 8i + 1 (i < kBatch; chunk i is in while n0 + 8i < N, as N %
// 8 == 0) of output row m, from their exact sums s[2i], s[2i + 1]. Every
// load of the batch is issued before its stores: out may alias acc_in, so
// the compiler cannot move a later load above an earlier store itself.
template <int kMode>
__device__ __forceinline__ void store_batch(const Epilogue& ep, size_t m, int n0, int N,
                                            float rsm, const int (&s)[2 * kBatch]) {
  const size_t row = m * N;
  if constexpr (kMode == kRaw) {
#pragma unroll
    for (int i = 0; i < kBatch; ++i)
      if (n0 + 8 * i < N)
        *reinterpret_cast<int2*>(static_cast<int*>(ep.out) + row + n0 + 8 * i) =
            make_int2(s[2 * i], s[2 * i + 1]);
    return;
  }
  float cs[2 * kBatch], bias[2 * kBatch], v[2 * kBatch];
#pragma unroll
  for (int i = 0; i < kBatch; ++i) {
    const int n = n0 + 8 * i;
    const bool in = n < N;
    cs[2 * i] = in ? __ldg(ep.cs + n) : 0.f;
    cs[2 * i + 1] = in ? __ldg(ep.cs + n + 1) : 0.f;
    bias[2 * i] = in && ep.bias ? __ldg(ep.bias + n) : 0.f;
    bias[2 * i + 1] = in && ep.bias ? __ldg(ep.bias + n + 1) : 0.f;
  }
  if constexpr (kMode == kQkv) {
#pragma unroll
    for (int e = 0; e < 2 * kBatch; ++e) {
      const float accb = __bfloat162float(__int2bfloat16_rn(s[e]));
      const float sc = bf16_round(__fmul_rn(rsm, cs[e]));
      const float prod = bf16_round(__fmul_rn(accb, sc));
      v[e] = __fadd_rn(prod, bf16_round(bias[e]));
    }
#pragma unroll
    for (int i = 0; i < kBatch; ++i)
      if (n0 + 8 * i < N)
        *reinterpret_cast<__nv_bfloat162*>(static_cast<bf16*>(ep.out) + row + n0 + 8 * i) =
            __floats2bfloat162_rn(v[2 * i], v[2 * i + 1]);  // the third rounding
    return;
  }
  float prev[2 * kBatch], res[2 * kBatch];
#pragma unroll
  for (int i = 0; i < kBatch; ++i) {
    const size_t off = row + n0 + 8 * i;
    const bool in = n0 + 8 * i < N;
    const float2 p = in && ep.acc_in ? *reinterpret_cast<const float2*>(ep.acc_in + off)
                                     : make_float2(0.f, 0.f);
    const float2 r = in && ep.res
                         ? __bfloat1622float2(__ldg(reinterpret_cast<const __nv_bfloat162*>(
                               ep.res + off)))
                         : make_float2(0.f, 0.f);
    prev[2 * i] = p.x, prev[2 * i + 1] = p.y, res[2 * i] = r.x, res[2 * i + 1] = r.y;
  }
#pragma unroll
  for (int e = 0; e < 2 * kBatch; ++e) {
    v[e] = __fmul_rn(__fmul_rn(static_cast<float>(s[e]), rsm), cs[e]);
    if (ep.acc_in) v[e] = __fadd_rn(prev[e], v[e]);
    if (ep.bias) v[e] = __fadd_rn(v[e], bias[e]);
    if (ep.gelu) v[e] = gelu_tanh(v[e]);
    if (ep.res) v[e] = __fadd_rn(v[e], res[e]);
  }
#pragma unroll
  for (int i = 0; i < kBatch; ++i) {
    const size_t off = row + n0 + 8 * i;
    if (n0 + 8 * i >= N) continue;
    if (ep.out_f32) {
      *reinterpret_cast<float2*>(static_cast<float*>(ep.out) + off) =
          make_float2(v[2 * i], v[2 * i + 1]);
    } else {
      *reinterpret_cast<__nv_bfloat162*>(static_cast<bf16*>(ep.out) + off) =
          __floats2bfloat162_rn(v[2 * i], v[2 * i + 1]);
    }
  }
}

template <int kMode>
__global__ void __launch_bounds__(kThreads, 1)
    gemm_s8_kernel(const __grid_constant__ CUtensorMap tm_a,
                   const __grid_constant__ CUtensorMap tm_w, int a_rows, int groups, int N, int K,
                   Epilogue ep) {
  extern __shared__ unsigned char smem_raw[];
  const uint32_t raw = smem_u32(smem_raw);
  const uint32_t base = (raw + 1023) & ~1023u;  // the swizzle pattern repeats every 1024 bytes
  const uint32_t full = base + kStages * kStageBytes, empty = full + 8 * kStages;
  const int tid = threadIdx.x;
  const int m_tiles = (a_rows + kBM - 1) / kBM;  // per row group
  const int n_tiles = (N + kBN - 1) / kBN;
  const int tiles = groups * m_tiles * n_tiles;
  const int k_tiles = (K + kBK - 1) / kBK;

  if (tid == 0) {
#pragma unroll
    for (int s = 0; s < kStages; ++s) {
      mbar_init(full + 8 * s, 1);
      mbar_init(empty + 8 * s, kConsumers);
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();

  // The launch bound leaves 168 registers a thread; the producer gives most
  // of its warpgroup's back, so the consumers' 128 accumulators fit in 232.
  if (tid >= kConsumers * 128) {  // the producer warpgroup: one thread issues every load
    asm volatile("setmaxnreg.dec.sync.aligned.u32 40;\n" ::: "memory");
    if (tid == kConsumers * 128) {
      int it = 0;
      for (int tile = blockIdx.x; tile < tiles; tile += gridDim.x) {
        const int nt = tile % n_tiles, mt = tile / n_tiles;
        const int g = mt / m_tiles, r0 = (mt % m_tiles) * kBM;
        for (int kt = 0; kt < k_tiles; ++kt, ++it) {
          const int s = it % kStages;
          mbar_wait(empty + 8 * s, ((it / kStages) & 1) ^ 1);  // a fresh ring passes
          mbar_expect_tx(full + 8 * s, kStageBytes);
          const uint32_t dst = base + s * kStageBytes;
          tma_load_3d(dst, &tm_a, kt * kBK, r0, g, full + 8 * s);
          tma_load_2d(dst + kATile, &tm_w, kt * kBK, nt * kBN, full + 8 * s);
        }
      }
    }
    return;
  }

  asm volatile("setmaxnreg.inc.sync.aligned.u32 232;\n" ::: "memory");
  const int wg = tid / 128, warp = (tid % 128) / 32, lane = tid % 32;
  const bool signals = tid % 128 == 0;  // hands the warpgroup's stages back
  // this thread's fragment: rows rw and rw + 8 of the warpgroup's 64, columns
  // 8c + cq and 8c + cq + 1 of each 8-column chunk c
  const int rw = wg * 64 + warp * 16 + lane / 4, cq = 2 * (lane % 4);
  int acc[128];
  int it = 0;
  for (int tile = blockIdx.x; tile < tiles; tile += gridDim.x) {
    const int nt = tile % n_tiles, mt = tile / n_tiles;
    const int g = mt / m_tiles, r0 = (mt % m_tiles) * kBM;
    for (int kt = 0; kt < k_tiles; ++kt, ++it) {
      const int s = it % kStages;
      mbar_wait(full + 8 * s, (it / kStages) & 1);
      const uint32_t a_s = base + s * kStageBytes + wg * 64 * kBK;
      const uint32_t w_s = base + s * kStageBytes + kATile;
      wg_fence();
#pragma unroll
      for (int kk = 0; kk < kBK / 32; ++kk)
        wgmma_s8(acc, desc128(a_s + 32 * kk), desc128(w_s + 32 * kk), kt > 0 || kk > 0);
      wg_commit();
      wg_wait_one();  // the stage before this one is consumed
      if (kt > 0 && signals) mbar_arrive(empty + 8 * ((it - 1) % kStages));
    }
    wg_wait_all();
    fence_regs(acc);
    if (signals) mbar_arrive(empty + 8 * ((it - 1) % kStages));

#pragma unroll
    for (int half = 0; half < 2; ++half) {
      const int r = r0 + rw + 8 * half;
      if (r >= a_rows) continue;
      const size_t m = static_cast<size_t>(g) * a_rows + r;
      const float rsm = kMode == kRaw ? 0.f : __ldg(ep.rs + m);
#pragma unroll
      for (int c0 = 0; c0 < kBN / 8; c0 += kBatch) {
        const int n0 = nt * kBN + 8 * c0 + cq;
        if (n0 >= N) break;  // this chunk and every later one are past N
        int sums[2 * kBatch];
#pragma unroll
        for (int i = 0; i < kBatch; ++i) {
          sums[2 * i] = acc[4 * (c0 + i) + 2 * half];
          sums[2 * i + 1] = acc[4 * (c0 + i) + 2 * half + 1];
        }
        store_batch<kMode>(ep, m, n0, N, rsm, sums);
      }
    }
  }
}

template <int kMode>
int launch(const CUtensorMap& tm_a, const CUtensorMap& tm_w, int a_rows, int groups, int N,
           int K, const Epilogue& ep, cudaStream_t stream) {
  auto kernel = gemm_s8_kernel<kMode>;
  cudaError_t err =
      cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, kSmemBytes);
  int sms = 0;
  if (err == cudaSuccess) err = sm_count(&sms);
  if (err != cudaSuccess) return static_cast<int>(err);
  const long long tiles = static_cast<long long>(groups) * ((a_rows + kBM - 1) / kBM) *
                          ((N + kBN - 1) / kBN);
  const int grid = static_cast<int>(tiles < sms ? tiles : sms);
  kernel<<<grid, kThreads, kSmemBytes, stream>>>(tm_a, tm_w, a_rows, groups, N, K, ep);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// Dynamic shared memory of a block and blocks resident per SM (the kLinear
// instantiation; the three share their layout).
extern "C" int s3_gemm_s8_occupancy(int* smem_bytes, int* blocks_per_sm) {
  auto kernel = gemm_s8_kernel<kLinear>;
  *smem_bytes = kSmemBytes;
  cudaError_t err =
      cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, kSmemBytes);
  if (err == cudaSuccess)
    err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(blocks_per_sm, kernel, kThreads,
                                                        kSmemBytes);
  return static_cast<int>(err);
}

extern "C" int s3_gemm_s8(const void* a, int lda, int a_rows, long long a_gstride,
                          const void* w, int ldw, int M, int N, int K,
                          const void* rs, const void* cs, const void* bias, const void* acc_in,
                          const void* res, void* out, int mode, int gelu, int out_f32,
                          void* stream) {
  const Epilogue ep{static_cast<const float*>(rs),   static_cast<const float*>(cs),
                    static_cast<const float*>(bias), static_cast<const float*>(acc_in),
                    static_cast<const bf16*>(res),   out,
                    gelu,                            out_f32};
  const int groups = M / a_rows;
  // A: (K, rows of a group, groups); a single group's stride is its extent
  const cuuint64_t a_dims[3] = {static_cast<cuuint64_t>(K), static_cast<cuuint64_t>(a_rows),
                                static_cast<cuuint64_t>(groups)};
  const cuuint64_t a_strides[2] = {
      static_cast<cuuint64_t>(lda),
      static_cast<cuuint64_t>(groups > 1 ? a_gstride : static_cast<long long>(a_rows) * lda)};
  const cuuint32_t a_box[3] = {kBK, kBM, 1};
  const cuuint64_t w_dims[2] = {static_cast<cuuint64_t>(K), static_cast<cuuint64_t>(N)};
  const cuuint64_t w_strides[1] = {static_cast<cuuint64_t>(ldw)};
  const cuuint32_t w_box[2] = {kBK, kBN};
  CUtensorMap tm_a, tm_w;
  cudaError_t err =
      swizzled_map(&tm_a, CU_TENSOR_MAP_DATA_TYPE_UINT8, 3, a, a_dims, a_strides, a_box);
  if (err == cudaSuccess)
    err = swizzled_map(&tm_w, CU_TENSOR_MAP_DATA_TYPE_UINT8, 2, w, w_dims, w_strides, w_box);
  if (err != cudaSuccess) return static_cast<int>(err);
  auto s = static_cast<cudaStream_t>(stream);
  switch (mode) {
    case kRaw: return launch<kRaw>(tm_a, tm_w, a_rows, groups, N, K, ep, s);
    case kQkv: return launch<kQkv>(tm_a, tm_w, a_rows, groups, N, K, ep, s);
    case kLinear: return launch<kLinear>(tm_a, tm_w, a_rows, groups, N, K, ep, s);
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}
