// Masked multi-head attention read straight from the fused [B, T, 3C] QKV
// buffer (bf16), head dim 64, output [B, T, C] bf16:
//   out[b, t, h] = softmax_k(q.k * Dh^-0.5 - 1e9 * (k >= kv_len[b])) . v
// with f32 scores and softmax, bf16 P.V operands and f32 accumulation.
//
// The attention core of the Pallas kernel `fused_attention_block_bf16`
// (s3prl_tpu/kernels/flash_attention.py:797, pallas_call at :772; the
// per-head loop at :733-751). The TPU kernel holds the whole utterance's
// [T, 3C] QKV in VMEM (3 MB at T=512, C=1024); an H100 SM has 227 KB, so
// this kernel re-tiles: one block per (64 queries, head, utterance), 4 warps
// of 16 query rows, K/V streamed through shared memory in 64-key tiles with
// an online softmax (running max and sum per row). Key tiles wholly past
// kv_len are skipped: the Pallas kernel's additive -1e9 makes their
// probabilities exactly 0 in f32. Keys past T (the ragged last tile) are
// excluded outright. The Pallas kernel normalises P before its bf16 cast;
// here P is unnormalised (<= 1) and the row sum divides at the end.
//
// Bound: tensor-core throughput of the two 64-deep products per tile
// (4*B*H*T^2*Dh FLOP, 33 GFLOP per layer at B=32, T=499), with the softmax
// on the CUDA cores between them. WMMA 16x16x16 fragments; the accumulator
// layout is opaque, so the per-row rescale of the running output goes
// through a per-warp f32 square in shared memory.
#include <mma.h>

#include "common.cuh"

namespace {

using namespace nvcuda;
using s3::bf16;

constexpr int kDh = 64;
constexpr int kBQ = 64, kBKV = 64;
constexpr int kWarps = 4;
constexpr int kLd = kDh + 8;  // bf16 shared row stride (144 bytes)
constexpr int kLdf = 64 + 4;  // f32 shared row stride
constexpr int kQBytes = kBQ * kLd * 2;
constexpr int kKVBytes = kBKV * kLd * 2;
constexpr int kSBytes = kWarps * 16 * kLdf * 4;
constexpr int kPBytes = kWarps * 16 * kLd * 2;
constexpr int kSmemBytes = kQBytes + 2 * kKVBytes + kSBytes + kPBytes;

__global__ void __launch_bounds__(kWarps * 32)
    attention_kernel(const bf16* __restrict__ qkv, const int* __restrict__ kv_lens,
                     bf16* __restrict__ out, int T, int H, float scale) {
  extern __shared__ __align__(128) unsigned char smem[];
  bf16* qs = reinterpret_cast<bf16*>(smem);
  bf16* ks = reinterpret_cast<bf16*>(smem + kQBytes);
  bf16* vs = reinterpret_cast<bf16*>(smem + kQBytes + kKVBytes);
  float* ss = reinterpret_cast<float*>(smem + kQBytes + 2 * kKVBytes);
  bf16* ps = reinterpret_cast<bf16*>(smem + kQBytes + 2 * kKVBytes + kSBytes);

  const int q0 = blockIdx.x * kBQ, h = blockIdx.y, b = blockIdx.z;
  const int C = H * kDh, stride = 3 * C;
  const bf16* base = qkv + static_cast<size_t>(b) * T * stride;
  const int tid = threadIdx.x, warp = tid / 32, lane = tid % 32;
  const int kv_len = min(max(kv_lens[b], 0), T);
  // kv_len == 0 (never produced by the model) attends uniformly over T keys
  const int n_tiles = (kv_len > 0 ? kv_len + kBKV - 1 : T + kBKV - 1) / kBKV;

  for (int i = tid; i < kBQ * (kDh / 8); i += kWarps * 32) {
    const int r = i / (kDh / 8), c = (i % (kDh / 8)) * 8;
    const bool p = q0 + r < T;
    s3::cp_async16(qs + r * kLd + c, p ? base + static_cast<size_t>(q0 + r) * stride + h * kDh + c
                                       : base, p);
  }
  s3::cp_async_commit();

  float* sw = ss + warp * 16 * kLdf;  // this warp's 16 x 64 f32 square
  bf16* pw = ps + warp * 16 * kLd;    // this warp's 16 x 64 bf16 P
  const int rr = lane / 2, half = lane % 2;  // two lanes per query row
  float m_i = -INFINITY, l_i = 0.f;

  wmma::fragment<wmma::matrix_a, 16, 16, 16, bf16, wmma::row_major> qf[kDh / 16];
  wmma::fragment<wmma::accumulator, 16, 16, 16, float> of[kDh / 16];
#pragma unroll
  for (int j = 0; j < kDh / 16; ++j) wmma::fill_fragment(of[j], 0.f);

  for (int kt = 0; kt < n_tiles; ++kt) {
    const int k0 = kt * kBKV;
    __syncthreads();  // every warp is done with the previous K/V tile
    for (int i = tid; i < kBKV * (kDh / 8); i += kWarps * 32) {
      const int r = i / (kDh / 8), c = (i % (kDh / 8)) * 8;
      const bool p = k0 + r < T;
      const bf16* src = base + static_cast<size_t>(k0 + r) * stride + h * kDh + c;
      s3::cp_async16(ks + r * kLd + c, p ? src + C : base, p);
      s3::cp_async16(vs + r * kLd + c, p ? src + 2 * C : base, p);
    }
    s3::cp_async_commit();
    s3::cp_async_wait<0>();
    __syncthreads();
    if (kt == 0) {
#pragma unroll
      for (int kk = 0; kk < kDh / 16; ++kk)
        wmma::load_matrix_sync(qf[kk], qs + warp * 16 * kLd + kk * 16, kLd);
    }

    // S = Q K^T for this warp's 16 rows x 64 keys
#pragma unroll
    for (int j = 0; j < kBKV / 16; ++j) {
      wmma::fragment<wmma::accumulator, 16, 16, 16, float> sf;
      wmma::fill_fragment(sf, 0.f);
#pragma unroll
      for (int kk = 0; kk < kDh / 16; ++kk) {
        wmma::fragment<wmma::matrix_b, 16, 16, 16, bf16, wmma::col_major> kf;
        wmma::load_matrix_sync(kf, ks + j * 16 * kLd + kk * 16, kLd);
        wmma::mma_sync(sf, qf[kk], kf, sf);
      }
      wmma::store_matrix_sync(sw + j * 16, sf, kLdf, wmma::mem_row_major);
    }
    __syncwarp();

    // online softmax on row rr, columns half*32 .. half*32+31
    float* srow = sw + rr * kLdf + half * 32;
    float mx = -INFINITY;
#pragma unroll 8
    for (int c = 0; c < 32; ++c) {
      const int col = k0 + half * 32 + c;
      float s = srow[c] * scale + (col < kv_len ? 0.f : -1e9f);
      if (col >= T) s = -INFINITY;
      srow[c] = s;
      mx = fmaxf(mx, s);
    }
    mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 1));
    const float m_new = fmaxf(m_i, mx);  // finite: key k0 < T is in every tile
    const float alpha = exp2f((m_i - m_new) * s3::kLog2e);
    float psum = 0.f;
    bf16* prow = pw + rr * kLd + half * 32;
#pragma unroll 8
    for (int c = 0; c < 32; ++c) {
      const float p = exp2f((srow[c] - m_new) * s3::kLog2e);
      psum += p;
      prow[c] = __float2bfloat16_rn(p);
    }
    psum += __shfl_xor_sync(0xffffffffu, psum, 1);
    l_i = l_i * alpha + psum;
    m_i = m_new;
    __syncwarp();

    // rescale the running output rows by alpha (through the f32 square)
#pragma unroll
    for (int j = 0; j < kDh / 16; ++j)
      wmma::store_matrix_sync(sw + j * 16, of[j], kLdf, wmma::mem_row_major);
    __syncwarp();
#pragma unroll 8
    for (int c = 0; c < 32; ++c) srow[c] *= alpha;
    __syncwarp();
#pragma unroll
    for (int j = 0; j < kDh / 16; ++j)
      wmma::load_matrix_sync(of[j], sw + j * 16, kLdf, wmma::mem_row_major);

    // O += P V
    wmma::fragment<wmma::matrix_a, 16, 16, 16, bf16, wmma::row_major> pf[kBKV / 16];
#pragma unroll
    for (int kk = 0; kk < kBKV / 16; ++kk) wmma::load_matrix_sync(pf[kk], pw + kk * 16, kLd);
#pragma unroll
    for (int j = 0; j < kDh / 16; ++j) {
#pragma unroll
      for (int kk = 0; kk < kBKV / 16; ++kk) {
        wmma::fragment<wmma::matrix_b, 16, 16, 16, bf16, wmma::row_major> vf;
        wmma::load_matrix_sync(vf, vs + kk * 16 * kLd + j * 16, kLd);
        wmma::mma_sync(of[j], pf[kk], vf, of[j]);
      }
    }
    __syncwarp();
  }

  // normalise and store this warp's rows
#pragma unroll
  for (int j = 0; j < kDh / 16; ++j)
    wmma::store_matrix_sync(sw + j * 16, of[j], kLdf, wmma::mem_row_major);
  __syncwarp();
  const int t = q0 + warp * 16 + rr;
  if (t < T) {
    const float inv = 1.f / l_i;
    bf16* orow = out + (static_cast<size_t>(b) * T + t) * C + h * kDh + half * 32;
    const float* srow = sw + rr * kLdf + half * 32;
#pragma unroll
    for (int c = 0; c < 32; c += 8) {
      float v[8];
#pragma unroll
      for (int e = 0; e < 8; ++e) v[e] = srow[c + e] * inv;
      s3::store8(orow + c, v);
    }
  }
}

}  // namespace

extern "C" int s3_attention(const void* qkv, const void* kv_lens, void* out, int batch, int T,
                            int H, float scale, void* stream) {
  cudaError_t err = cudaFuncSetAttribute(
      attention_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, kSmemBytes);
  if (err != cudaSuccess) return static_cast<int>(err);
  const dim3 grid((T + kBQ - 1) / kBQ, H, batch);
  attention_kernel<<<grid, kWarps * 32, kSmemBytes, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const bf16*>(qkv), static_cast<const int*>(kv_lens), static_cast<bf16*>(out), T,
      H, scale);
  return static_cast<int>(cudaGetLastError());
}
