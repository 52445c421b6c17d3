// bf16 GEMM with f32 accumulation and a fused epilogue:
//   out[m, n] = act(sum_k a[m, k] * w[n, k] + bias[n]) (+ res[m, n])
// a [M, K] bf16 row-major (activations), w [N, K] bf16 row-major (torch
// nn.Linear layout), bias f32 [N], res bf16 [M, N] or null, act = erf GELU
// or identity, out bf16 (rounded to nearest even) or f32.
//
// Serves every GEMM that the bf16 whole-block Pallas kernels compute in
// their own bodies:
//   - attention block (s3prl_tpu/kernels/flash_attention.py:797): the QKV
//     projection with its bias and bf16 cast (:727-732) and the output
//     projection with bias and residual (:752-757);
//   - FFN block (s3prl_tpu/kernels/ffn.py:350): fc1 + b1 -> GELU -> bf16
//     (:273-277) and fc2 + b2 (+x) (:278-296). The Pallas kernel's f32 sum
//     over 1024-wide FFN panels is this kernel's K loop.
//
// Bound: tensor-core throughput (HuBERT-Large at B=32: M = 15,968 rows,
// K = 1024 or 4096; ~400 GFLOP per layer). Design, kept simple for a first
// port: 128x128x32 block tiles, 8 warps each owning a 64x32 accumulator tile
// of WMMA 16x16x16 bf16 fragments, a two-stage cp.async pipeline so the next
// K slab loads while the tensor cores work on this one, padded shared-memory
// rows (80 bytes) against bank conflicts, zero-filled loads at the ragged M,
// N and K edges. The epilogue stages one 16x16 fragment per warp in shared
// memory and writes 16-byte vectors. wgmma, TMA and a persistent schedule
// are later work.
#include <mma.h>

#include "common.cuh"

namespace {

using namespace nvcuda;
using s3::bf16;

constexpr int kBM = 128, kBN = 128, kBK = 32;
constexpr int kLds = kBK + 8;  // shared row stride in elements
constexpr int kThreads = 256;  // 8 warps: 2 along M x 4 along N
constexpr int kWM = 64, kWN = 32;
constexpr int kFM = kWM / 16, kFN = kWN / 16;
constexpr int kSmemBytes = 2 * (kBM + kBN) * kLds * 2;

__global__ void __launch_bounds__(kThreads)
    gemm_bf16_kernel(const bf16* __restrict__ a, const bf16* __restrict__ w,
                     const float* __restrict__ bias, const bf16* __restrict__ res,
                     void* __restrict__ out, int out_f32, int gelu, int M, int N, int K) {
  __shared__ __align__(128) unsigned char smem[kSmemBytes];
  bf16* as = reinterpret_cast<bf16*>(smem);  // [2][kBM][kLds]
  bf16* bs = as + 2 * kBM * kLds;            // [2][kBN][kLds]

  const int bm = blockIdx.y * kBM, bn = blockIdx.x * kBN;
  const int tid = threadIdx.x, warp = tid / 32, lane = tid % 32;
  const int wm = warp / 4, wn = warp % 4;

  wmma::fragment<wmma::accumulator, 16, 16, 16, float> acc[kFM][kFN];
#pragma unroll
  for (int i = 0; i < kFM; ++i)
#pragma unroll
    for (int j = 0; j < kFN; ++j) wmma::fill_fragment(acc[i][j], 0.f);

  auto load_tile = [&](int stage, int k0) {
    for (int i = tid; i < kBM * (kBK / 8); i += kThreads) {
      const int r = i / (kBK / 8), c = (i % (kBK / 8)) * 8;
      const int gr = bm + r, gc = k0 + c;
      const bool p = gr < M && gc < K;
      s3::cp_async16(as + (stage * kBM + r) * kLds + c, p ? a + static_cast<size_t>(gr) * K + gc : a,
                 p);
    }
    for (int i = tid; i < kBN * (kBK / 8); i += kThreads) {
      const int r = i / (kBK / 8), c = (i % (kBK / 8)) * 8;
      const int gr = bn + r, gc = k0 + c;
      const bool p = gr < N && gc < K;
      s3::cp_async16(bs + (stage * kBN + r) * kLds + c, p ? w + static_cast<size_t>(gr) * K + gc : w,
                 p);
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
    const int st = kt & 1;
#pragma unroll
    for (int kk = 0; kk < kBK; kk += 16) {
      wmma::fragment<wmma::matrix_a, 16, 16, 16, bf16, wmma::row_major> af[kFM];
      wmma::fragment<wmma::matrix_b, 16, 16, 16, bf16, wmma::col_major> bfr[kFN];
#pragma unroll
      for (int i = 0; i < kFM; ++i)
        wmma::load_matrix_sync(af[i], as + (st * kBM + wm * kWM + i * 16) * kLds + kk, kLds);
#pragma unroll
      for (int j = 0; j < kFN; ++j)
        wmma::load_matrix_sync(bfr[j], bs + (st * kBN + wn * kWN + j * 16) * kLds + kk, kLds);
#pragma unroll
      for (int i = 0; i < kFM; ++i)
#pragma unroll
        for (int j = 0; j < kFN; ++j) wmma::mma_sync(acc[i][j], af[i], bfr[j], acc[i][j]);
    }
    __syncthreads();  // this stage is overwritten by the load two steps on
  }
  s3::cp_async_wait<0>();

  // Epilogue: the tiles are consumed, so the shared memory is free for a
  // 16x16 f32 staging square per warp.
  float* stage = reinterpret_cast<float*>(smem) + warp * 256;
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
        float v[8];
#pragma unroll
        for (int e = 0; e < 8; ++e) {
          v[e] = stage[r * 16 + c0 + e] + bias[gn + e];
          if (gelu) v[e] = s3::gelu_erf(v[e]);
        }
        const size_t off = static_cast<size_t>(gm) * N + gn;
        if (res) {
          float rv[8];
          s3::load8(res + off, rv);
#pragma unroll
          for (int e = 0; e < 8; ++e) v[e] += rv[e];
        }
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

}  // namespace

extern "C" int s3_gemm_bf16(const void* a, const void* w, const void* bias, const void* res,
                            void* out, int out_f32, int gelu, int M, int N, int K,
                            void* stream) {
  const dim3 grid((N + kBN - 1) / kBN, (M + kBM - 1) / kBM);
  gemm_bf16_kernel<<<grid, kThreads, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const bf16*>(a), static_cast<const bf16*>(w), static_cast<const float*>(bias),
      static_cast<const bf16*>(res), out, out_f32, gelu, M, N, K);
  return static_cast<int>(cudaGetLastError());
}
