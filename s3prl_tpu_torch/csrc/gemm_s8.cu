// int8 x int8 -> exact int32 GEMM on the tensor cores, with the dequantizing
// epilogues of the int8 whole-block kernels:
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
//     (kLinear, :615-621; f32 out when the postnorm LN follows);
//   - `fused_int8_ffn` (s3prl_tpu/kernels/ffn.py:160, pallas_call at :129):
//     fc1 with scale, bias and tanh GELU in f32 (kLinear + gelu, :94-99), and
//     fc2 once per FFN chunk, each adding its dequantized sum to the f32
//     running output (kLinear + acc_in, :101-105); the last chunk adds b2 and
//     x (:106-109);
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
// at B=32, K = 1024 or 2048 per chunk, N up to 4096). Design, kept simple
// for a first port (the twin of gemm_bf16.cu): 128x128x64 block tiles, 8
// warps each owning a 64x32 tile of WMMA 16x16x16 int8 fragments with int32
// accumulators, a two-stage cp.async pipeline, zero-filled loads at the
// ragged M, N and K edges. Shared memory holds each tile as 16-byte K slabs
// ([slab][row][16 bytes]), so every fragment pointer is 256-bit aligned and
// a fragment load reads 256 contiguous bytes. The epilogue stages one 16x16
// int32 fragment per warp in shared memory. mma.sync with in-register
// scales, wgmma and TMA are later work.
#include <mma.h>

#include "common.cuh"

namespace {

using namespace nvcuda;
using s3::bf16;

constexpr int kBM = 128, kBN = 128, kBK = 64;
constexpr int kSlab = 16;  // K bytes per WMMA step
constexpr int kSlabs = kBK / kSlab;
constexpr int kThreads = 256;  // 8 warps: 2 along M x 4 along N
constexpr int kWM = 64, kWN = 32;
constexpr int kFM = kWM / 16, kFN = kWN / 16;
constexpr int kStageBytes = (kBM + kBN) * kBK;
constexpr int kSmemBytes = 2 * kStageBytes;

enum Mode { kRaw = 0, kQkv = 1, kLinear = 2 };

struct Epilogue {
  const float* rs;
  const float* cs;
  const float* bias;    // null: no bias
  const float* acc_in;  // [M, N] f32 or null; may alias out
  const bf16* res;      // [M, N] bf16 or null
  void* out;            // [M, N]
  int mode, gelu, out_f32;
};

__device__ __forceinline__ float bf16_round(float v) {
  return __bfloat162float(__float2bfloat16_rn(v));
}

__global__ void __launch_bounds__(kThreads)
    gemm_s8_kernel(const int8_t* __restrict__ a, int lda, int a_rows, long long a_gstride,
                   const int8_t* __restrict__ w, int ldw, int M, int N, int K, Epilogue ep) {
  __shared__ __align__(128) signed char smem[kSmemBytes];

  const int bm = blockIdx.y * kBM, bn = blockIdx.x * kBN;
  const int tid = threadIdx.x, warp = tid / 32, lane = tid % 32;
  const int wm = warp / 4, wn = warp % 4;

  wmma::fragment<wmma::accumulator, 16, 16, 16, int> acc[kFM][kFN];
#pragma unroll
  for (int i = 0; i < kFM; ++i)
#pragma unroll
    for (int j = 0; j < kFN; ++j) wmma::fill_fragment(acc[i][j], 0);

  // Each thread loads one 16-byte slab of rows lr and lr + 64 of both tiles
  // at every K step: their row addresses are fixed, so they are computed once.
  constexpr int kRowStep = kThreads / kSlabs;
  static_assert(kBM == 2 * kRowStep && kBN == 2 * kRowStep, "two load rows per thread");
  const int lr = tid / kSlabs, sl = tid % kSlabs;
  const int8_t* arow[2];
  const int8_t* wrow[2];
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    const int gm = bm + lr + h * kRowStep, gn = bn + lr + h * kRowStep;
    arow[h] = gm < M ? a + (gm / a_rows) * a_gstride + static_cast<long long>(gm % a_rows) * lda
                     : nullptr;
    wrow[h] = gn < N ? w + static_cast<size_t>(gn) * ldw : nullptr;
  }
  auto load_tile = [&](int stage, int k0) {
    signed char* as = smem + stage * kStageBytes;  // [slab][kBM][16]
    signed char* bs = as + kBM * kBK;              // [slab][kBN][16]
    const int gc = k0 + sl * kSlab;
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int r = lr + h * kRowStep;
      const bool pa = arow[h] && gc < K, pw = wrow[h] && gc < K;
      s3::cp_async16(as + (sl * kBM + r) * kSlab, pa ? arow[h] + gc : a, pa);
      s3::cp_async16(bs + (sl * kBN + r) * kSlab, pw ? wrow[h] + gc : w, pw);
    }
  };

  const int ktiles = (K + kBK - 1) / kBK;
  load_tile(0, 0);
  s3::cp_async_commit();
  for (int kt = 0; kt < ktiles; ++kt) {
    if (kt + 1 < ktiles) load_tile((kt + 1) & 1, (kt + 1) * kBK);
    s3::cp_async_commit();  // possibly empty: keeps the group count uniform
    s3::cp_async_wait<1>();
    __syncthreads();
    const signed char* as = smem + (kt & 1) * kStageBytes;
    const signed char* bs = as + kBM * kBK;
#pragma unroll
    for (int sl = 0; sl < kSlabs; ++sl) {
      wmma::fragment<wmma::matrix_a, 16, 16, 16, signed char, wmma::row_major> af[kFM];
      wmma::fragment<wmma::matrix_b, 16, 16, 16, signed char, wmma::col_major> bfr[kFN];
#pragma unroll
      for (int i = 0; i < kFM; ++i)
        wmma::load_matrix_sync(af[i], as + (sl * kBM + wm * kWM + i * 16) * kSlab, kSlab);
#pragma unroll
      for (int j = 0; j < kFN; ++j)
        wmma::load_matrix_sync(bfr[j], bs + (sl * kBN + wn * kWN + j * 16) * kSlab, kSlab);
#pragma unroll
      for (int i = 0; i < kFM; ++i)
#pragma unroll
        for (int j = 0; j < kFN; ++j) wmma::mma_sync(acc[i][j], af[i], bfr[j], acc[i][j]);
    }
    __syncthreads();  // this stage is overwritten by the load two steps on
  }
  s3::cp_async_wait<0>();

  // Epilogue: the tiles are consumed, so the shared memory is free for a
  // 16x16 int32 staging square per warp.
  int* stage = reinterpret_cast<int*>(smem) + warp * 256;
  const int r = lane / 2, c0 = (lane % 2) * 8;
#pragma unroll
  for (int i = 0; i < kFM; ++i) {
#pragma unroll
    for (int j = 0; j < kFN; ++j) {
      wmma::store_matrix_sync(stage, acc[i][j], 16, wmma::mem_row_major);
      __syncwarp();
      const int gm = bm + wm * kWM + i * 16 + r;
      const int gn = bn + wn * kWN + j * 16 + c0;
      if (gm < M && gn < N) {  // N % 8 == 0: a run of 8 is all in or all out
        const int* sv = stage + r * 16 + c0;
        const size_t off = static_cast<size_t>(gm) * N + gn;
        if (ep.mode == kRaw) {
          int4* o = reinterpret_cast<int4*>(static_cast<int*>(ep.out) + off);
          o[0] = make_int4(sv[0], sv[1], sv[2], sv[3]);
          o[1] = make_int4(sv[4], sv[5], sv[6], sv[7]);
        } else if (ep.mode == kQkv) {
          const float rsm = ep.rs[gm];
          float v[8];
#pragma unroll
          for (int e = 0; e < 8; ++e) {
            const float accb = __bfloat162float(__int2bfloat16_rn(sv[e]));
            const float sc = bf16_round(__fmul_rn(rsm, ep.cs[gn + e]));
            const float prod = bf16_round(__fmul_rn(accb, sc));
            v[e] = __fadd_rn(prod, bf16_round(ep.bias[gn + e]));
          }
          s3::store8(static_cast<bf16*>(ep.out) + off, v);  // the third rounding
        } else {
          const float rsm = ep.rs[gm];
          float v[8];
#pragma unroll
          for (int e = 0; e < 8; ++e)
            v[e] = __fmul_rn(__fmul_rn(static_cast<float>(sv[e]), rsm), ep.cs[gn + e]);
          if (ep.acc_in) {
            const float4* ai = reinterpret_cast<const float4*>(ep.acc_in + off);
            const float4 a0 = ai[0], a1 = ai[1];
            const float prev[8] = {a0.x, a0.y, a0.z, a0.w, a1.x, a1.y, a1.z, a1.w};
#pragma unroll
            for (int e = 0; e < 8; ++e) v[e] = __fadd_rn(prev[e], v[e]);
          }
          if (ep.bias) {
#pragma unroll
            for (int e = 0; e < 8; ++e) v[e] = __fadd_rn(v[e], ep.bias[gn + e]);
          }
          if (ep.gelu) {
#pragma unroll
            for (int e = 0; e < 8; ++e) v[e] = s3::gelu_tanh(v[e]);
          }
          if (ep.res) {
            float rv[8];
            s3::load8(ep.res + off, rv);
#pragma unroll
            for (int e = 0; e < 8; ++e) v[e] = __fadd_rn(v[e], rv[e]);
          }
          if (ep.out_f32) {
            s3::store8(static_cast<float*>(ep.out) + off, v);
          } else {
            s3::store8(static_cast<bf16*>(ep.out) + off, v);
          }
        }
      }
      __syncwarp();
    }
  }
}

}  // namespace

extern "C" int s3_gemm_s8(const void* a, int lda, int a_rows, long long a_gstride,
                          const void* w, int ldw, int M, int N, int K,
                          const void* rs, const void* cs, const void* bias, const void* acc_in,
                          const void* res, void* out, int mode, int gelu, int out_f32,
                          void* stream) {
  const Epilogue ep{static_cast<const float*>(rs),     static_cast<const float*>(cs),
                    static_cast<const float*>(bias),   static_cast<const float*>(acc_in),
                    static_cast<const bf16*>(res),     out,
                    mode,                              gelu,
                    out_f32};
  const dim3 grid((N + kBN - 1) / kBN, (M + kBM - 1) / kBM);
  gemm_s8_kernel<<<grid, kThreads, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const int8_t*>(a), lda, a_rows, a_gstride, static_cast<const int8_t*>(w), ldw,
      M, N, K, ep);
  return static_cast<int>(cudaGetLastError());
}
