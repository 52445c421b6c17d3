// int8 x int8 -> exact int32 GEMM on Hopper's tensor cores (wgmma, TMA),
// with the dequantizing epilogues of the int8 whole-block kernels:
//   acc[m, n] = sum_k a[m, k] * w[n, k]
// a [M, K] int8 with row stride lda, in row groups: row m = (g, r) = (m /
// a_rows, m % a_rows) starts at a + g * a_gstride + r * lda (one group of M
// rows is a plain matrix; a stride-2 conv tap's rows of x [B, T, C] are B
// groups of T' rows with lda = 2C), w [N, K] int8 with row
// stride ldw (nn.Linear layout; a K range of a wider matrix is a pointer
// offset plus its row stride), then per output element one of
//   kRaw     out int32 = acc;
//   kQkv     out bf16 = bf16(bf16(bf16(acc) * bf16(rs[m] * cs[n])) + bf16(bias[n]));
//   kLinear  v = f32(acc) * rs[m] * cs[n]; [v = acc_in[m, n] + v]; [v = v + bias[n]];
//            [v = gelu_tanh(v)]; [v = v + f32(res[m, n])]; out f32 or bf16.
// rs are per-row activation scales, cs per-output-channel weight scales.
//
// Serves the int8 products that the Pallas kernels compute in their own
// bodies and that neither int8_panel.cu nor int8_conv.cu (K13b) takes:
//   - `fused_attention_block` (s3prl_tpu/kernels/flash_attention.py:664,
//     pallas_call at :633): the QKV GEMM with its three bf16 roundings
//     (kQkv, :537-544) and the out-proj with scale, bias and residual in f32
//     (kLinear, :615-621; f32 out when the postnorm LN follows) for rows
//     wider than int8_panel.cu takes; K11's out-proj (:629), and K6's (:413)
//     for rows wider than the panel;
//   - `fused_int8_ffn` (s3prl_tpu/kernels/ffn.py:160, pallas_call at :129):
//     fc1 with scale, bias and tanh GELU in f32 (kLinear + gelu, :94-99), and
//     fc2 once per FFN chunk, each adding its dequantized sum to the f32
//     running output (kLinear + acc_in, :101-105); the last chunk adds b2 and
//     x (:106-109); K12 `fused_int8_linear` (:238) for rows wider than the
//     panel.
// int32 sums are exact in any order, so kRaw equals torch._int_mm bit for
// bit. Every f32 operation of the epilogues is an explicit __fmul_rn /
// __fadd_rn, so none is contracted into an FMA and each rounds in the order
// the Pallas kernel writes.
//
// Bound: tensor-core throughput at the main path's shapes (M = 15,968 rows
// at B=32, K = 1024 or 2048 per chunk, N up to 4096: 134 GOP for fc1).
// Design: the persistent TMA + wgmma GEMM of hopper.cuh (s3::gemm: 128 x
// 256 tiles, a four-stage ring of 128-byte K stages, two consumer
// warpgroups on wgmma m64n256k32 s8 x s8 -> s32), shared with gemm_bf16.cu;
// here the epilogues, 8 chunks at a time, each batch's loads (scales, bias,
// the f32 sum it adds to, the residual) issued before its stores. What holds
// it back (PERF.md): the epilogue does not overlap the products (both
// warpgroups run it at once), and the tiles' reads from L2 (784 MB for K2's
// fc1) are near L2's rate; a ping-pong schedule (each warpgroup on tiles of
// its own, main loops in turn) and cluster multicast are the next steps.
#include "hopper.cuh"

namespace {

using namespace s3;

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
__global__ void __launch_bounds__(gemm::kThreads, 1)
    gemm_s8_kernel(const __grid_constant__ gemm::AMaps tm_a,
                   const __grid_constant__ CUtensorMap tm_w, gemm::Shape sh, Epilogue ep) {
  extern __shared__ unsigned char smem_raw[];
  const gemm::Ring ring = gemm::ring(smem_raw);
  const int tid = threadIdx.x;

  // The launch bound leaves 168 registers a thread; the producer gives most
  // of its warpgroup's back, so the consumers' 128 accumulators fit in 232.
  if (tid >= gemm::kConsumers * 128) {  // the producer warpgroup: one thread issues every load
    asm volatile("setmaxnreg.dec.sync.aligned.u32 40;\n" ::: "memory");
    if (tid == gemm::kConsumers * 128) gemm::produce<gemm::kStageK>(tm_a, tm_w, sh, ring);
    return;
  }

  asm volatile("setmaxnreg.inc.sync.aligned.u32 232;\n" ::: "memory");
  const int wg = tid / 128, warp = (tid % 128) / 32, lane = tid % 32;
  // this thread's fragment: rows rw and rw + 8 of the warpgroup's 64, columns
  // 8c + cq and 8c + cq + 1 of each 8-column chunk c
  const int rw = wg * 64 + warp * 16 + lane / 4, cq = 2 * (lane % 4);
  const int k_tiles = (sh.K + gemm::kStageK - 1) / gemm::kStageK;
  int acc[128];
  int it = 0;
  for (int tile = blockIdx.x; tile < sh.tiles; tile += gridDim.x) {
    const gemm::Tile t = gemm::tile_at(sh, tile);
    gemm::consume(acc, ring, wg, k_tiles, it);

#pragma unroll
    for (int half = 0; half < 2; ++half) {
      const int r = t.r0 + rw + 8 * half;
      if (r >= sh.a_rows) continue;
      const size_t m = static_cast<size_t>(t.g) * sh.a_rows + r;
      const float rsm = kMode == kRaw ? 0.f : __ldg(ep.rs + m);
#pragma unroll
      for (int c0 = 0; c0 < gemm::kBN / 8; c0 += kBatch) {
        const int n0 = t.nt * gemm::kBN + 8 * c0 + cq;
        if (n0 >= sh.N) break;  // this chunk and every later one are past N
        int sums[2 * kBatch];
#pragma unroll
        for (int i = 0; i < kBatch; ++i) {
          sums[2 * i] = acc[4 * (c0 + i) + 2 * half];
          sums[2 * i + 1] = acc[4 * (c0 + i) + 2 * half + 1];
        }
        store_batch<kMode>(ep, m, n0, sh.N, rsm, sums);
      }
    }
  }
}

template <int kMode>
int launch(const gemm::AMaps& tm_a, const CUtensorMap& tm_w, const gemm::Shape& sh,
           const Epilogue& ep, cudaStream_t stream) {
  auto kernel = gemm_s8_kernel<kMode>;
  int grid = 0;
  const cudaError_t err = gemm::prepare(kernel, sh, &grid);
  if (err != cudaSuccess) return static_cast<int>(err);
  kernel<<<grid, gemm::kThreads, gemm::kSmemBytes, stream>>>(tm_a, tm_w, sh, ep);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// Dynamic shared memory of a block and blocks resident per SM (the kLinear
// instantiation; the three share their layout).
extern "C" int s3_gemm_s8_occupancy(int* smem_bytes, int* blocks_per_sm) {
  return static_cast<int>(gemm::occupancy(gemm_s8_kernel<kLinear>, smem_bytes, blocks_per_sm));
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
  gemm::Shape sh = gemm::shape(a_rows, M, N, K);
  gemm::AMaps tm_a;
  CUtensorMap tm_w;
  cudaError_t err = gemm::a_maps(&tm_a, &sh.tap, CU_TENSOR_MAP_DATA_TYPE_UINT8, 1, a, lda,
                                 a_rows, a_gstride, sh.groups, K);
  if (err == cudaSuccess) err = gemm::w_map(&tm_w, CU_TENSOR_MAP_DATA_TYPE_UINT8, 1, w, ldw, N, K);
  if (err != cudaSuccess) return static_cast<int>(err);
  auto s = static_cast<cudaStream_t>(stream);
  switch (mode) {
    case kRaw: return launch<kRaw>(tm_a, tm_w, sh, ep, s);
    case kQkv: return launch<kQkv>(tm_a, tm_w, sh, ep, s);
    case kLinear: return launch<kLinear>(tm_a, tm_w, sh, ep, s);
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}
