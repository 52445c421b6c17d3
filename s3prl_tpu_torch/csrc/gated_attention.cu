// Masked attention in f32 on [B, H, T, 64] bf16 q, k, v (q pre-scaled by
// Dh^-0.5), output [B, H, T, 64] bf16, with or without WavLM's gated
// relative-position bias (pos_bias [H, T, T] f32, shared by the utterances;
// gate [B, H, T] f32):
//   s_k = q_t.k_k [+ gate[b, h, t] * pos_bias[h, t, k]]  for k < kv_len[b],
//         `masked` otherwise
//   out[b, h, t] = sum_k p_k v_k / max(sum_k p_k, l_floor),  p_k = exp(s_k - m)
//
// One source for three Pallas kernels (s3prl_tpu/kernels/flash_attention.py):
// - K9 `gated_bias_attention` (pallas_call :105, cell `_attn_kernel` :59-89),
//   the whole-T cell for T <= MAX_KERNEL_T: masked = -1e9, no floor
//   (l_floor = 0);
// - K10 `_gated_online_flash_kernel` (pallas_call :963, cell
//   `_gated_online_kernel` :901-945), K-blocked beyond it: masked = -1e30,
//   l_floor = 1e-30;
// - K17 `flash_attention` (pallas_call :1020, cell `_attn_kernel_nobias`
//   :994-1011), the no-bias instantiation (kGated = false: no gate or bias
//   is read): masked = -1e9, no floor.
// On the TPU they differ because a whole [T, T] score tile must fit VMEM;
// here all are K-blocked, so they share one kernel and differ in the two
// constants and the template flag.
//
// The design is online_attention.cu's (K8): one block per (64 queries,
// head, utterance), 4 warps of 16 query rows, K/V streamed through shared
// memory in 64-key tiles with cp.async, double-buffered; f32 online
// softmax; S = Q K^T on bf16 WMMA (a product of two bf16 values is exact in
// f32); P.V exact in f32 by splitting each probability into three bf16
// parts, p = hi + mid + lo. On top of that, the bias: after a warp stores
// its 16 x 64 f32 score square, its lanes read the square's pos_bias rows
// straight from device memory (lanes along the keys, so each row is one
// coalesced read) and add gate * bias to each valid score, the product
// first and then the sum in f32 (__fmul_rn, __fadd_rn: no contraction), as
// the cell writes it. The 64 gates of the block sit in shared memory.
//
// Block order: blockIdx.x is the utterance, so the B blocks that read the
// same [64, T] rows of pos_bias are launched together and hit L2 (the TPU
// kernel's batch-innermost grid, :65-69); otherwise the f32 bias would come
// from device memory B times (2.3 GB a layer at 60 s, B = 4).
//
// Masking: the softmax sees `masked` for keys at or past kv_len. A key tile
// wholly past kv_len contributes exactly 0 (exp2 of masked - m underflows
// once a valid score has set m), so those tiles are skipped; keys past T
// are past kv_len. kv_len = 0 is outside the contract (the model never
// produces it): no tile runs, and the row is 0 / l_floor.
//
// Bound: at WavLM-Large's shapes the bytes (q, k, v, out, and the f32
// pos_bias, 576 MB at T = 2999) take less time than the tensor-core issue
// of the four 64-deep products per tile (S, and P.V three times), with the
// softmax and the bias read between them on the CUDA cores.
#include <mma.h>

#include "common.cuh"

namespace {

using namespace nvcuda;
using s3::bf16;

constexpr int kDh = 64;
constexpr int kBQ = 64, kBKV = 64;
constexpr int kWarps = 4;
constexpr int kParts = 3;     // bf16 parts of one f32 probability
constexpr int kLd = kDh + 8;  // bf16 shared row stride (144 bytes)
constexpr int kLdf = 64 + 4;  // f32 shared row stride
constexpr int kTileBytes = kBQ * kLd * 2;
constexpr int kSBytes = kWarps * 16 * kLdf * 4;
constexpr int kPBytes = kWarps * 16 * kLd * 2;
constexpr int kGateBytes = kBQ * 4;
// Q, two stages of (K, V), the per-warp f32 squares, the three P parts, the gates
constexpr int kSmemBytes =
    kTileBytes + 2 * 2 * kTileBytes + kSBytes + kParts * kPBytes + kGateBytes;

__device__ __forceinline__ void load_tile(bf16* dst, const bf16* src, int r0, int T, int tid) {
  for (int i = tid; i < kBKV * (kDh / 8); i += kWarps * 32) {
    const int r = i / (kDh / 8), c = (i % (kDh / 8)) * 8;
    const bool p = r0 + r < T;
    s3::cp_async16(dst + r * kLd + c, p ? src + static_cast<size_t>(r0 + r) * kDh + c : src, p);
  }
}

template <bool kGated>
__global__ void __launch_bounds__(kWarps * 32)
    gated_attention_kernel(const bf16* __restrict__ q, const bf16* __restrict__ k,
                           const bf16* __restrict__ v, const float* __restrict__ pos_bias,
                           const float* __restrict__ gate, const int* __restrict__ kv_lens,
                           bf16* __restrict__ out, int H, int T, float masked, float l_floor) {
  extern __shared__ __align__(128) unsigned char smem[];
  bf16* qs = reinterpret_cast<bf16*>(smem);
  bf16* kvs = reinterpret_cast<bf16*>(smem + kTileBytes);  // [stage][K, V]
  float* ss = reinterpret_cast<float*>(smem + 5 * kTileBytes);
  bf16* ps = reinterpret_cast<bf16*>(smem + 5 * kTileBytes + kSBytes);
  float* gs = reinterpret_cast<float*>(smem + 5 * kTileBytes + kSBytes + kParts * kPBytes);

  const int b = blockIdx.x, q0 = blockIdx.y * kBQ, h = blockIdx.z;
  const size_t head = (static_cast<size_t>(b) * H + h) * T;
  const bf16 *qh = q + head * kDh, *kh = k + head * kDh, *vh = v + head * kDh;
  const float* bias_h = pos_bias + static_cast<size_t>(h) * T * T;
  const int tid = threadIdx.x, warp = tid / 32, lane = tid % 32;
  const int kv_len = min(max(kv_lens[b], 0), T);
  const int n_tiles = (kv_len + kBKV - 1) / kBKV;

  if (kGated && tid < kBQ) gs[tid] = q0 + tid < T ? gate[head + q0 + tid] : 0.f;
  load_tile(qs, qh, q0, T, tid);
  if (n_tiles > 0) {
    load_tile(kvs, kh, 0, T, tid);
    load_tile(kvs + kBKV * kLd, vh, 0, T, tid);
  }
  s3::cp_async_commit();

  float* sw = ss + warp * 16 * kLdf;  // this warp's 16 x 64 f32 square
  const int rr = lane / 2, half = lane % 2;  // two lanes per query row
  float m_i = masked, l_i = 0.f;

  wmma::fragment<wmma::matrix_a, 16, 16, 16, bf16, wmma::row_major> qf[kDh / 16];
  wmma::fragment<wmma::accumulator, 16, 16, 16, float> of[kDh / 16];
#pragma unroll
  for (int j = 0; j < kDh / 16; ++j) wmma::fill_fragment(of[j], 0.f);

  for (int kt = 0; kt < n_tiles; ++kt) {
    const int k0 = kt * kBKV;
    if (kt + 1 < n_tiles) {  // the next tile goes to the other stage
      bf16* next = kvs + ((kt + 1) % 2) * 2 * kBKV * kLd;
      load_tile(next, kh, k0 + kBKV, T, tid);
      load_tile(next + kBKV * kLd, vh, k0 + kBKV, T, tid);
      s3::cp_async_commit();
      s3::cp_async_wait<1>();
    } else {
      s3::cp_async_wait<0>();
    }
    __syncthreads();
    const bf16* ks = kvs + (kt % 2) * 2 * kBKV * kLd;
    const bf16* vs = ks + kBKV * kLd;
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

    // S += gate * pos_bias on the valid keys; lanes along the keys of a row
#pragma unroll
    for (int r = 0; r < (kGated ? 16 : 0); ++r) {
      const int t = q0 + warp * 16 + r;
      if (t < T) {
        const float g = gs[warp * 16 + r];
        const float* brow = bias_h + static_cast<size_t>(t) * T + k0;
#pragma unroll
        for (int c = lane; c < kBKV; c += 32)
          if (k0 + c < kv_len)
            sw[r * kLdf + c] = __fadd_rn(sw[r * kLdf + c], __fmul_rn(g, __ldg(brow + c)));
      }
    }
    __syncwarp();

    // online softmax on row rr, columns half*32 .. half*32+31
    float* srow = sw + rr * kLdf + half * 32;
    float mx = masked;
#pragma unroll 8
    for (int c = 0; c < 32; ++c) {
      const float s = k0 + half * 32 + c < kv_len ? srow[c] : masked;
      srow[c] = s;
      mx = fmaxf(mx, s);
    }
    mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 1));
    const float m_new = fmaxf(m_i, mx);
    const float alpha = exp2f((m_i - m_new) * s3::kLog2e);
    float psum = 0.f;
#pragma unroll 8
    for (int c = 0; c < 32; ++c) {
      const float p = exp2f((srow[c] - m_new) * s3::kLog2e);
      psum += p;
      const bf16 hi = __float2bfloat16_rn(p);
      const float r = p - __bfloat162float(hi);  // exact
      const bf16 mid = __float2bfloat16_rn(r);
      const bf16 lo = __float2bfloat16_rn(r - __bfloat162float(mid));  // exact
      const int at = warp * 16 * kLd + rr * kLd + half * 32 + c;
      ps[at] = hi;
      ps[kPBytes / 2 + at] = mid;
      ps[kPBytes + at] = lo;
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

    // O += (hi + mid + lo) V
    wmma::fragment<wmma::matrix_a, 16, 16, 16, bf16, wmma::row_major> pf[kParts][kBKV / 16];
#pragma unroll
    for (int part = 0; part < kParts; ++part)
#pragma unroll
      for (int kk = 0; kk < kBKV / 16; ++kk)
        wmma::load_matrix_sync(pf[part][kk],
                               ps + part * (kPBytes / 2) + warp * 16 * kLd + kk * 16, kLd);
#pragma unroll
    for (int j = 0; j < kDh / 16; ++j) {
#pragma unroll
      for (int kk = 0; kk < kBKV / 16; ++kk) {
        wmma::fragment<wmma::matrix_b, 16, 16, 16, bf16, wmma::row_major> vf;
        wmma::load_matrix_sync(vf, vs + kk * 16 * kLd + j * 16, kLd);
#pragma unroll
        for (int part = kParts - 1; part >= 0; --part)  // the small parts first
          wmma::mma_sync(of[j], pf[part][kk], vf, of[j]);
      }
    }
    __syncthreads();  // every warp is done with this stage before it is refilled
  }
  s3::cp_async_wait<0>();  // the Q tile, when no key tile ran

  // normalise and store this warp's rows
#pragma unroll
  for (int j = 0; j < kDh / 16; ++j)
    wmma::store_matrix_sync(sw + j * 16, of[j], kLdf, wmma::mem_row_major);
  __syncwarp();
  const int t = q0 + warp * 16 + rr;
  if (t < T) {
    const float l = fmaxf(l_i, l_floor);
    bf16* orow = out + (head + t) * kDh + half * 32;
    const float* srow = sw + rr * kLdf + half * 32;
#pragma unroll
    for (int c = 0; c < 32; c += 8) {
      float o[8];
#pragma unroll
      for (int e = 0; e < 8; ++e) o[e] = srow[c + e] / l;
      s3::store8(orow + c, o);
    }
  }
}

template <bool kGated>
int launch(const void* q, const void* k, const void* v, const void* pos_bias, const void* gate,
           const void* kv_lens, void* out, int batch, int H, int T, float masked, float l_floor,
           void* stream) {
  cudaError_t err = cudaFuncSetAttribute(
      gated_attention_kernel<kGated>, cudaFuncAttributeMaxDynamicSharedMemorySize, kSmemBytes);
  if (err != cudaSuccess) return static_cast<int>(err);
  const dim3 grid(batch, (T + kBQ - 1) / kBQ, H);  // the utterance varies fastest
  gated_attention_kernel<kGated>
      <<<grid, kWarps * 32, kSmemBytes, static_cast<cudaStream_t>(stream)>>>(
          static_cast<const bf16*>(q), static_cast<const bf16*>(k), static_cast<const bf16*>(v),
          static_cast<const float*>(pos_bias), static_cast<const float*>(gate),
          static_cast<const int*>(kv_lens), static_cast<bf16*>(out), H, T, masked, l_floor);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

extern "C" int s3_gated_attention(const void* q, const void* k, const void* v,
                                  const void* pos_bias, const void* gate, const void* kv_lens,
                                  void* out, int batch, int H, int T, float masked,
                                  float l_floor, void* stream) {
  return launch<true>(q, k, v, pos_bias, gate, kv_lens, out, batch, H, T, masked, l_floor,
                      stream);
}

// K17: no bias, the -1e9 mask, no floor.
extern "C" int s3_flash_attention(const void* q, const void* k, const void* v,
                                  const void* kv_lens, void* out, int batch, int H, int T,
                                  void* stream) {
  return launch<false>(q, k, v, nullptr, nullptr, kv_lens, out, batch, H, T, -1e9f, 0.f, stream);
}
