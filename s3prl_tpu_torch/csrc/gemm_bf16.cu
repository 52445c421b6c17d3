// bf16 GEMM with f32 accumulation and a fused epilogue on Hopper's tensor
// cores (wgmma, TMA):
//   out[m, n] = act(sum_k a[m, k] * w[n, k] [+ bias[n]]) [+ res[m, n]]
// a [M, K] bf16 in row groups: row m = (g, r) = (m / a_rows, m % a_rows)
// starts at a + g * a_gstride + r * lda (one group of M rows with lda = K is
// a plain row-major matrix; K14's stride-2 conv reads its im2col rows
// straight from x [B, T, C] as B groups of T' rows with lda = 2C, rows that
// overlap when k = 3). w [N, K] bf16 row-major (torch nn.Linear layout),
// bias f32 [N] or null, res bf16 [M, N] or null, act = erf GELU or
// identity, out [M, N] bf16 (rounded to nearest even) or f32.
//
// Serves every GEMM that the bf16 whole-block Pallas kernels compute in
// their own bodies:
//   - attention block (s3prl_tpu/kernels/flash_attention.py:797): the QKV
//     projection with its bias and bf16 cast (:727-732) and the output
//     projection with bias and residual (:752-757);
//   - FFN block (s3prl_tpu/kernels/ffn.py:350): fc1 + b1 -> GELU -> bf16
//     (:273-277) and fc2 + b2 (+x) (:278-296). The Pallas kernel's f32 sum
//     over 1024-wide FFN panels is this kernel's K loop;
//   - the mid-conv front end (s3prl_tpu/kernels/conv_frontend.py:301,
//     `_mid_kernel_bf16`): the k taps as one K = k * C GEMM into f32, which
//     ln_gelu.cu then normalises.
// The f32 sums run in another order than the TPU's (each product of two bf16
// values is exact in f32); the epilogue adds the bias, applies the GELU,
// adds the residual and casts once, in that order.
//
// Bound: tensor-core throughput (HuBERT-Large at B=32: M = 15,968 rows, K =
// 1024 or 4096; 268 GFLOP for the FFN's two products). Design: the
// persistent TMA + wgmma GEMM of hopper.cuh (s3::gemm: 128 x 256 output
// tiles walked columns fastest by one block per SM, a four-stage ring of
// 64-element K stages filled by one producer thread, two consumer
// warpgroups on wgmma m64n256k16 bf16 x bf16 -> f32 with 128 accumulators a
// thread), shared with gemm_s8.cu. K14's overlapping k = 3 rows are read
// through one map per tap run (hopper.cuh). The epilogue goes straight from
// the accumulator registers, 8 chunks of 8 columns at a time, each batch's
// loads (bias, residual) issued before its stores; the producer meanwhile
// fills the ring with the next tile's first stages.
#include "hopper.cuh"

namespace {

using namespace s3;

constexpr int kBK = gemm::kStageK / 2;  // bf16 elements of K a stage

struct Epilogue {
  const float* bias;  // [N] or null
  const bf16* res;    // [M, N] or null
  void* out;          // [M, N] bf16 or f32
  int gelu, out_f32;
};

constexpr int kBatch = 8;  // 8-column chunks whose loads are issued before their stores

// One row's batch of kBatch chunks of this thread's fragment: columns n0 +
// 8i and n0 + 8i + 1 (i < kBatch; chunk i is in while n0 + 8i < N, as N %
// 8 == 0) of output row m, from their f32 sums s[2i], s[2i + 1].
__device__ __forceinline__ void store_batch(const Epilogue& ep, size_t m, int n0, int N,
                                            const float (&s)[2 * kBatch]) {
  const size_t row = m * N;
  float bias[2 * kBatch], res[2 * kBatch], v[2 * kBatch];
#pragma unroll
  for (int i = 0; i < kBatch; ++i) {
    const int n = n0 + 8 * i;
    const bool in = n < N;
    const float2 b = in && ep.bias ? __ldg(reinterpret_cast<const float2*>(ep.bias + n))
                                   : make_float2(0.f, 0.f);
    const float2 r = in && ep.res
                         ? __bfloat1622float2(__ldg(reinterpret_cast<const __nv_bfloat162*>(
                               ep.res + row + n)))
                         : make_float2(0.f, 0.f);
    bias[2 * i] = b.x, bias[2 * i + 1] = b.y, res[2 * i] = r.x, res[2 * i + 1] = r.y;
  }
#pragma unroll
  for (int e = 0; e < 2 * kBatch; ++e) {
    v[e] = ep.bias ? s[e] + bias[e] : s[e];
    if (ep.gelu) v[e] = gelu_erf(v[e]);
    if (ep.res) v[e] += res[e];
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

__global__ void __launch_bounds__(gemm::kThreads, 1)
    gemm_bf16_kernel(const __grid_constant__ gemm::AMaps tm_a,
                     const __grid_constant__ CUtensorMap tm_w, gemm::Shape sh, Epilogue ep) {
  extern __shared__ unsigned char smem_raw[];
  const gemm::Ring ring = gemm::ring(smem_raw);
  const int tid = threadIdx.x;

  // The launch bound leaves 168 registers a thread; the producer gives most
  // of its warpgroup's back, so the consumers' 128 accumulators fit in 232.
  if (tid >= gemm::kConsumers * 128) {  // the producer warpgroup: one thread issues every load
    asm volatile("setmaxnreg.dec.sync.aligned.u32 40;\n" ::: "memory");
    if (tid == gemm::kConsumers * 128) gemm::produce<kBK>(tm_a, tm_w, sh, ring);
    return;
  }

  asm volatile("setmaxnreg.inc.sync.aligned.u32 232;\n" ::: "memory");
  const int wg = tid / 128, warp = (tid % 128) / 32, lane = tid % 32;
  // this thread's fragment: rows rw and rw + 8 of the warpgroup's 64, columns
  // 8c + cq and 8c + cq + 1 of each 8-column chunk c
  const int rw = wg * 64 + warp * 16 + lane / 4, cq = 2 * (lane % 4);
  const int k_tiles = (sh.K + kBK - 1) / kBK;
  float acc[128];
  int it = 0;
  for (int tile = blockIdx.x; tile < sh.tiles; tile += gridDim.x) {
    const gemm::Tile t = gemm::tile_at(sh, tile);
    gemm::consume(acc, ring, wg, k_tiles, it);

#pragma unroll
    for (int half = 0; half < 2; ++half) {
      const int r = t.r0 + rw + 8 * half;
      if (r >= sh.a_rows) continue;
      const size_t m = static_cast<size_t>(t.g) * sh.a_rows + r;
#pragma unroll
      for (int c0 = 0; c0 < gemm::kBN / 8; c0 += kBatch) {
        const int n0 = t.nt * gemm::kBN + 8 * c0 + cq;
        if (n0 >= sh.N) break;  // this chunk and every later one are past N
        float sums[2 * kBatch];
#pragma unroll
        for (int i = 0; i < kBatch; ++i) {
          sums[2 * i] = acc[4 * (c0 + i) + 2 * half];
          sums[2 * i + 1] = acc[4 * (c0 + i) + 2 * half + 1];
        }
        store_batch(ep, m, n0, sh.N, sums);
      }
    }
  }
}

}  // namespace

// Dynamic shared memory of a block and blocks resident per SM.
extern "C" int s3_gemm_bf16_occupancy(int* smem_bytes, int* blocks_per_sm) {
  return static_cast<int>(gemm::occupancy(gemm_bf16_kernel, smem_bytes, blocks_per_sm));
}

// w: [N, K] contiguous (ldw = K); every pointer 16-byte aligned, lda and
// a_gstride multiples of 8 elements.
extern "C" int s3_gemm_bf16(const void* a, int lda, int a_rows, long long a_gstride,
                            const void* w, const void* bias, const void* res, void* out,
                            int out_f32, int gelu, int M, int N, int K, void* stream) {
  const Epilogue ep{static_cast<const float*>(bias), static_cast<const bf16*>(res), out, gelu,
                    out_f32};
  gemm::Shape sh = gemm::shape(a_rows, M, N, K);
  gemm::AMaps tm_a;
  CUtensorMap tm_w;
  cudaError_t err = gemm::a_maps(&tm_a, &sh.tap, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 2, a, lda,
                                 a_rows, a_gstride, sh.groups, K);
  if (err == cudaSuccess)
    err = gemm::w_map(&tm_w, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 2, w, K, N, K);
  int grid = 0;
  if (err == cudaSuccess) err = gemm::prepare(gemm_bf16_kernel, sh, &grid);
  if (err != cudaSuccess) return static_cast<int>(err);
  gemm_bf16_kernel<<<grid, gemm::kThreads, gemm::kSmemBytes, static_cast<cudaStream_t>(stream)>>>(
      tm_a, tm_w, sh, ep);
  return static_cast<int>(cudaGetLastError());
}
