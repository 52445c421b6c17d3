// K13b `fused_int8_conv_ln_gelu` as one kernel: a stride-2 conv (k = 2 or
// 3) over int8 rows with per-row scales, its f32 tap sum kept on chip, then
// the row's LayerNorm, erf GELU and per-row int8 (or, in the chain's last
// layer, one cast to bf16):
//   acc[b, j, n] = over t < k in tap order (tap 0 assigned, later taps added)
//                  (f32(sum_c xq[b, 2j + t, c] * wq[t, n, c]) * xs[b, 2j + t]) * ws[t, n];
//   y = GELU(LN(acc)) in f32; codes clip(rint(y / s)), s = max(absmax, 1e-8)
//   / 127 (IEEE division), or y cast once (bf16) or kept (f32).
// xq [B, T, 512] int8, xs [B, T] f32, wq [k, 512, 512] int8 codes (tap-major,
// nn.Linear layout per tap) with scales ws [k, 512], gamma / beta [512] f32;
// out [B, T', 512], T' = (T - k) / 2 + 1.
//
// Replaces `fused_int8_conv_ln_gelu` (s3prl_tpu/kernels/conv_frontend.py:325,
// pallas_call at :370, cell `_mid_kernel` :207-243), which keeps the tap sum
// in VMEM and never writes the conv output to HBM; neither does this kernel.
// Every f32 operation of the tap sum and of the LN affine is an explicit
// __fmul_rn / __fadd_rn, so the sum equals the plain version's bit for bit
// (the int32 products are exact). The LN (biased variance, eps 1e-5, the
// affine in the written order) and erf GELU follow common.cuh's
// ln_gelu_row512, the quantizer quant_row512 (s = max(absmax, 1e-8) / 127,
// codes rint(y / s), both divisions exact as IEEE division: `div_by`). The
// statistics are summed in another order (per thread, across its quad, then
// the four warpgroups' quarters) and 1 / sqrt(var + eps) is rsqrtf's (within
// 2 ulp), so they can differ from torch's in the last bits; given them, the
// codes, scales and bf16 rows equal the plain version's bit for bit. A test
// mode (`sum_out`) also writes the tap sum and the statistics.
//
// Bound: the int8 tensor rate (1.56 TOP over the six mid layers at B=32 x 10
// s). Design:
//   - A tile is 64 output rows of one utterance x all 512 channels, so the
//     row epilogue runs on chip; a cluster of two blocks shares it, block r
//     taking channels 256 r .. 256 r + 255, and the two exchange each row's
//     partial statistics (sum, squared deviations, absmax) through
//     distributed shared memory, each read once both halves are in (an
//     mbarrier that counts the local and the remote writers).
//   - In a block, two consumer warpgroups own 128 channels each: per tap, a
//     warpgroup runs wgmma m64n128k32 s8 over K = 512 into 64 int32
//     accumulators, then folds them into its f32 tap sum, 64 registers a
//     thread, with the tap's row and column scales. (One block owning all
//     512 channels held 128 sums a thread beside the accumulators and
//     spilled 16-72 bytes a thread under any register split.)
//   - A: the tile's rows of every tap stay resident, k x 64 rows x 512 bytes
//     (96 KB at k = 3), loaded by TMA through one 3-D map per tap (K bytes,
//     T' rows 2C apart from byte t C, B utterances T C apart): tap t's row j
//     is x row 2j + t, read in place; the map's bounds zero-fill each
//     utterance's ragged last tile, and no tile crosses an utterance. The
//     next tile's rows load once both warpgroups' last products are done,
//     while the epilogue runs. The row scales xs[b, 2j + t] are read in
//     place too (two per tap a thread).
//   - W: the block's 256 channels streamed from L2 by TMA through a
//     three-stage ring of 32 KB stages (256 channels x 128 bytes of K), k x
//     128 KB a tile.
//   - A producer warpgroup (one thread issues every load) beside the two
//     consumer warpgroups, 384 threads; it gives most of its registers to
//     them (setmaxnreg 40 / 232).
//   - The epilogue: row reductions across the quad, through shared memory
//     across the two warpgroups and through the peer block's shared memory
//     across the cluster; codes transposed within each quad so that a lane
//     stores 8 consecutive bytes.
//   - Persistent grid: as many clusters as the card holds at once, each
//     walking tiles in utterance order.
// Shared memory: A 96 KB + ring 96 KB + tap scales 6 KB + LN affine 4 KB +
// row reductions 3 KB + barriers = 211,032 bytes with the alignment slack.
// Offsets into x, xs and out are computed in size_t (x reaches 524 MB).
#include "hopper.cuh"

namespace {

using namespace s3;

constexpr int kC = 512;                     // channels in and out
constexpr int kMaxTaps = 3;
constexpr int kBM = 64;                     // output rows a tile
constexpr int kBK = 128;                    // bytes of K a box
constexpr int kKBoxes = kC / kBK;           // K boxes a tap
constexpr int kCluster = 2;                 // blocks a tile, each half of the channels
constexpr int kNB = kC / kCluster;          // channels a block
constexpr int kNC = kNB / 2;                // channels a consumer warpgroup (wgmma n128)
constexpr int kConsumers = 256;             // two consumer warpgroups
constexpr int kThreads = kConsumers + 128;  // + the producer warpgroup
constexpr int kABox = kBM * kBK;            // 8 KB
constexpr int kATap = kKBoxes * kABox;      // 32 KB
constexpr int kWStage = kNB * kBK;          // 32 KB
constexpr int kStages = 3;
constexpr int kRingOff = kMaxTaps * kATap;
constexpr int kWsOff = kRingOff + kStages * kWStage;
constexpr int kLnOff = kWsOff + kMaxTaps * kC * 4;
constexpr int kRedOff = kLnOff + 2 * kC * 4;   // [3 reductions][2 warpgroups][64 rows] f32
constexpr int kXRedOff = kRedOff + 3 * 2 * kBM * 4;  // [3][2 blocks][64 rows] f32
constexpr int kBarOff = kXRedOff + 3 * kCluster * kBM * 4;
constexpr int kBars = 2 * kStages + 2 + 3;  // full, empty, a_full, a_empty, 3 exchanges
constexpr int kSmemBytes = kBarOff + kBars * 8 + 1024;  // + alignment slack
constexpr int kBarRows = 1;                 // named barrier of the consumer threads

struct Maps {
  CUtensorMap a[kMaxTaps];  // tap t's rows (unused past k)
  CUtensorMap w;            // [k 512 rows, 512]
};

struct Params {
  const float* xs;     // [B, T] row scales
  const float* ws;     // [k, 512]
  const float* gamma;  // [512]
  const float* beta;
  int T, t_out, k, m_tiles, tiles;
  void* out;           // [B, T', 512]: int8 codes (scale set), else bf16 or f32
  float* scale;        // [B, T'] or null (rows out)
  int out_f32;         // rows out: f32, else bf16
  float* sum_out;      // test mode: the tap sum [B T', 512], or null
  float* stats_out;    // test mode: the LN statistics [B T', 2] (mean, 1 / sqrt(var + eps))
};

// The shared-memory layout (offsets from the 1024-aligned base).
struct Smem {
  uint32_t a_s, ring, full, empty, a_full, a_empty, xbar;
  float *ws, *ln, *red, *xred;
};

__device__ __forceinline__ uint32_t cluster_rank() {
  uint32_t r;
  asm volatile("mov.u32 %0, %%cluster_ctarank;\n" : "=r"(r));
  return r;
}
// Every thread of both blocks of the cluster.
__device__ __forceinline__ void cluster_sync() {
  asm volatile("barrier.cluster.arrive.release;\nbarrier.cluster.wait.acquire;\n" ::: "memory");
}
// The address of this block's shared-memory word `addr` in block `rank`.
__device__ __forceinline__ uint32_t peer_addr(uint32_t addr, uint32_t rank) {
  uint32_t r;
  asm volatile("mapa.shared::cluster.u32 %0, %1, %2;\n" : "=r"(r) : "r"(addr), "r"(rank));
  return r;
}
__device__ __forceinline__ void st_cluster(uint32_t addr, float v) {
  asm volatile("st.shared::cluster.f32 [%0], %1;\n" ::"r"(addr), "f"(v) : "memory");
}
__device__ __forceinline__ void mbar_arrive_cluster(uint32_t addr) {
  asm volatile("mbarrier.arrive.release.cluster.shared::cluster.b64 _, [%0];\n" ::"r"(addr)
               : "memory");
}
// mbar_wait whose phase completes on arrivals from the other block too.
__device__ __forceinline__ void mbar_wait_cluster(uint32_t bar, int parity) {
  uint32_t done = 0;
  while (!done) {
    asm volatile(
        "{\n.reg .pred p;\nmbarrier.try_wait.parity.acquire.cluster.shared::cta.b64 p, [%1], %2;\n"
        "selp.u32 %0, 1, 0, p;\n}\n"
        : "=r"(done)
        : "r"(bar), "r"(parity)
        : "memory");
  }
}

// The producer thread: per tile, every W stage of the block's channels in
// (tap, K box) order, each into its ring slot once both warpgroups have
// handed the slot back; the tile's A rows once the ring's first stages are
// in flight and the last tile's products are done.
__device__ __forceinline__ void produce(const Maps& maps, const Params& p, const Smem& sm,
                                        int rank) {
  const int per_tile = p.k * kKBoxes;  // > kStages
  int it = 0, tl = 0;
  for (int tile = blockIdx.x / kCluster; tile < p.tiles; tile += gridDim.x / kCluster, ++tl) {
    const int b = tile / p.m_tiles, j0 = (tile % p.m_tiles) * kBM;
    for (int st = 0; st < per_tile; ++st, ++it) {
      if (st == kStages) {
        mbar_wait(sm.a_empty, (tl & 1) ^ 1);  // a fresh barrier passes
        mbar_expect_tx(sm.a_full, p.k * kATap);
        for (int t = 0; t < p.k; ++t)
          for (int kb = 0; kb < kKBoxes; ++kb)
            tma_load_3d(sm.a_s + t * kATap + kb * kABox, &maps.a[t], kb * kBK, j0, b, sm.a_full);
      }
      const int s = it % kStages, t = st / kKBoxes, kb = st % kKBoxes;
      mbar_wait(sm.empty + 8 * s, ((it / kStages) & 1) ^ 1);
      mbar_expect_tx(sm.full + 8 * s, kWStage);
      tma_load_2d(sm.ring + s * kWStage, &maps.w, kb * kBK, t * kC + rank * kNB, sm.full + 8 * s);
    }
  }
}

// The row totals of one reduction: part[h] is this thread's partial of row
// row[h]; `op` combines (sum or max). Quad, then the two warpgroups through
// `red`, then the two blocks: threads 0-63 write their row's block partial
// into both blocks' `xred` and arrive on both blocks' exchange barrier, and
// every consumer thread reads the totals once it completes (block 0's
// partial first, in both blocks).
template <typename Op>
__device__ __forceinline__ void row_totals(float (&part)[2], const int (&row)[2], int wg, int q,
                                           float* red, float* xred, uint32_t xbar, int parity,
                                           int rank, Op op) {
  const int tid = threadIdx.x;
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    part[h] = op(part[h], __shfl_xor_sync(0xffffffffu, part[h], 1));
    part[h] = op(part[h], __shfl_xor_sync(0xffffffffu, part[h], 2));
    if (q == 0) red[wg * kBM + row[h]] = part[h];
  }
  bar_sync(kBarRows, kConsumers);
  if (tid < kBM) {
    const float v = op(red[tid], red[kBM + tid]);
    xred[rank * kBM + tid] = v;
    st_cluster(peer_addr(smem_u32(xred + rank * kBM + tid), rank ^ 1), v);
    mbar_arrive_cluster(peer_addr(xbar, rank ^ 1));
    mbar_arrive_cluster(peer_addr(xbar, rank));
  }
  mbar_wait_cluster(xbar, parity);
#pragma unroll
  for (int h = 0; h < 2; ++h) part[h] = op(xred[row[h]], xred[kBM + row[h]]);
}

// A consumer warpgroup's share of every tile of this block: the products,
// the f32 tap sum in registers and the row epilogue.
__device__ __forceinline__ void consume(const Params& p, const Smem& sm, int rank) {
  const int tid = threadIdx.x;
  const int wg = tid / 128, warp = (tid % 128) / 32, lane = tid % 32, q = lane % 4;
  // this thread's fragment: rows r_lo and r_lo + 8 of the tile; channels
  // n0 + 8 c + 2 q + e (c < 16, e < 2), in sum[4 c + 2 h + e]
  const int r_lo = warp * 16 + lane / 4;
  const int row[2] = {r_lo, r_lo + 8};
  const int n0 = rank * kNB + wg * kNC;
  const bool signals = tid % 128 == 0;  // hands the warpgroup's stages back
  float sum[kNC / 2];
  int it = 0, tl = 0;
  for (int tile = blockIdx.x / kCluster; tile < p.tiles; tile += gridDim.x / kCluster, ++tl) {
    const int b = tile / p.m_tiles, j0 = (tile % p.m_tiles) * kBM;
    bool valid[2];
#pragma unroll
    for (int h = 0; h < 2; ++h) valid[h] = j0 + row[h] < p.t_out;
    mbar_wait(sm.a_full, tl & 1);
#pragma unroll
    for (int t = 0; t < kMaxTaps; ++t) {
      if (t >= p.k) break;
      float rs[2];  // the tap's scale of each row: xs[b, 2j + t]
#pragma unroll
      for (int h = 0; h < 2; ++h)
        rs[h] = valid[h] ? __ldg(p.xs + static_cast<size_t>(b) * p.T + 2 * (j0 + row[h]) + t)
                         : 0.f;
      int acc[kNC / 2];  // the tap's first product overwrites it (scale-d 0)
      for (int kb = 0; kb < kKBoxes; ++kb, ++it) {
        const int s = it % kStages;
        mbar_wait(sm.full + 8 * s, (it / kStages) & 1);
        const uint32_t a_b = sm.a_s + t * kATap + kb * kABox;
        const uint32_t w_b = sm.ring + s * kWStage + wg * kNC * kBK;
        wg_fence();
#pragma unroll
        for (int kk = 0; kk < kBK / 32; ++kk)
          wgmma_n128(acc, desc128(a_b + 32 * kk), desc128(w_b + 32 * kk), kb > 0 || kk > 0);
        wg_commit();
        wg_wait_one();  // the stage before this one is consumed
        if (kb > 0 && signals) mbar_arrive(sm.empty + 8 * ((it - 1) % kStages));
      }
      wg_wait_all();
      fence_regs(acc);
      if (signals) {
        mbar_arrive(sm.empty + 8 * ((it - 1) % kStages));
        if (t == p.k - 1) mbar_arrive(sm.a_empty);  // the A rows are read
      }
      const float* wst = sm.ws + t * kC + n0 + 2 * q;
#pragma unroll
      for (int c = 0; c < kNC / 8; ++c) {
        const float2 w2 = *reinterpret_cast<const float2*>(wst + 8 * c);
#pragma unroll
        for (int h = 0; h < 2; ++h)
#pragma unroll
          for (int e = 0; e < 2; ++e) {
            const int i = 4 * c + 2 * h + e;
            const float tap =
                __fmul_rn(__fmul_rn(static_cast<float>(acc[i]), rs[h]), e ? w2.y : w2.x);
            sum[i] = t == 0 ? tap : __fadd_rn(sum[i], tap);
          }
      }
    }

    // ---- the row epilogue, from the registers ----
    const size_t m0 = static_cast<size_t>(b) * p.t_out + j0;  // output row of tile row 0
    if (p.sum_out != nullptr) {
#pragma unroll
      for (int c = 0; c < kNC / 8; ++c)
#pragma unroll
        for (int h = 0; h < 2; ++h)
          if (valid[h])
            *reinterpret_cast<float2*>(p.sum_out + (m0 + row[h]) * kC + n0 + 8 * c + 2 * q) =
                make_float2(sum[4 * c + 2 * h], sum[4 * c + 2 * h + 1]);
    }
    const auto add = [](float x, float y) { return x + y; };
    const auto larger = [](float x, float y) { return fmaxf(x, y); };
    float mean[2], rstd[2], part[2] = {0.f, 0.f};
#pragma unroll
    for (int i = 0; i < kNC / 2; ++i) part[(i / 2) % 2] += sum[i];
    row_totals(part, row, wg, q, sm.red, sm.xred, sm.xbar, tl & 1, rank, add);
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      mean[h] = part[h] / 512.f;
      part[h] = 0.f;
    }
#pragma unroll
    for (int i = 0; i < kNC / 2; ++i) {
      const float d = sum[i] - mean[(i / 2) % 2];
      part[(i / 2) % 2] += d * d;
    }
    row_totals(part, row, wg, q, sm.red + 2 * kBM, sm.xred + kCluster * kBM, sm.xbar + 8,
               tl & 1, rank, add);
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      rstd[h] = rsqrtf(part[h] / 512.f + 1e-5f);
      if (p.stats_out != nullptr && rank == 0 && wg == 0 && q == 0 && valid[h]) {
        p.stats_out[2 * (m0 + row[h])] = mean[h];
        p.stats_out[2 * (m0 + row[h]) + 1] = rstd[h];
      }
    }
#pragma unroll
    for (int c = 0; c < kNC / 8; ++c) {
      const int n = n0 + 8 * c + 2 * q;
      const float2 g = *reinterpret_cast<const float2*>(sm.ln + n);
      const float2 be = *reinterpret_cast<const float2*>(sm.ln + kC + n);
#pragma unroll
      for (int h = 0; h < 2; ++h)
#pragma unroll
        for (int e = 0; e < 2; ++e) {
          float& v = sum[4 * c + 2 * h + e];
          v = gelu_erf(__fadd_rn(__fmul_rn(__fmul_rn(v - mean[h], rstd[h]), e ? g.y : g.x),
                                 e ? be.y : be.x));
        }
    }

    if (p.scale == nullptr) {  // the chain's last layer: rows in the model dtype
#pragma unroll
      for (int c = 0; c < kNC / 8; ++c)
#pragma unroll
        for (int h = 0; h < 2; ++h)
          if (valid[h]) {
            const size_t off = (m0 + row[h]) * kC + n0 + 8 * c + 2 * q;
            const float y0 = sum[4 * c + 2 * h], y1 = sum[4 * c + 2 * h + 1];
            if (p.out_f32)
              *reinterpret_cast<float2*>(static_cast<float*>(p.out) + off) = make_float2(y0, y1);
            else
              *reinterpret_cast<__nv_bfloat162*>(static_cast<bf16*>(p.out) + off) =
                  __floats2bfloat162_rn(y0, y1);
          }
      continue;
    }
    part[0] = part[1] = 0.f;
#pragma unroll
    for (int i = 0; i < kNC / 2; ++i) part[(i / 2) % 2] = fmaxf(part[(i / 2) % 2], fabsf(sum[i]));
    row_totals(part, row, wg, q, sm.red + 4 * kBM, sm.xred + 2 * kCluster * kBM, sm.xbar + 16,
               tl & 1, rank, larger);
    float s[2];
    double r[2];
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      // max(absmax, 1e-8) / 127, the division exact as in div_by (127 < 2^24)
      s[h] = div_by(fmaxf(part[h], 1e-8f), 1.0 / 127.0);
      r[h] = recip(s[h]);
      if (rank == 0 && wg == 0 && q == 0 && valid[h]) p.scale[m0 + row[h]] = s[h];
    }
    // Codes: a lane holds 2 of each 8-channel chunk; four lanes of a quad
    // exchange theirs so that lane q stores chunk 4 g + q's 8 bytes whole.
#pragma unroll
    for (int h = 0; h < 2; ++h)
#pragma unroll
      for (int g = 0; g < kNC / 32; ++g) {
        uint32_t u[4];  // chunk 4 g + i's two codes of row h
#pragma unroll
        for (int i = 0; i < 4; ++i) {
          const int k0 = 4 * (4 * g + i) + 2 * h;
          u[i] = static_cast<uint32_t>(static_cast<uint8_t>(quant_code(div_by(sum[k0], r[h])))) |
                 static_cast<uint32_t>(
                     static_cast<uint8_t>(quant_code(div_by(sum[k0 + 1], r[h]))))
                     << 8;
        }
        const uint32_t lo = u[0] | (u[1] << 16), hi = u[2] | (u[3] << 16);
        uint32_t out_lo = 0, out_hi = 0;
#pragma unroll
        for (int rd = 0; rd < 4; ++rd) {
          const int src = (q + rd) & 3;   // the quad lane read in round rd
          const int give = (q - rd) & 3;  // the chunk this lane gives in round rd
          const uint32_t mine = (((give & 2) ? hi : lo) >> (16 * (give & 1))) & 0xffffu;
          const uint32_t got = rd ? __shfl_sync(0xffffffffu, mine, (lane & ~3) | src) : mine;
          if (src < 2)
            out_lo |= got << (16 * src);
          else
            out_hi |= got << (16 * (src - 2));
        }
        if (valid[h])
          *reinterpret_cast<uint2*>(static_cast<int8_t*>(p.out) + (m0 + row[h]) * kC + n0 +
                                    8 * (4 * g + q)) = make_uint2(out_lo, out_hi);
      }
  }
}

__global__ void __launch_bounds__(kThreads, 1)
    int8_conv_kernel(const __grid_constant__ Maps maps, const Params p) {
  extern __shared__ unsigned char smem_raw[];
  const uint32_t raw = smem_u32(smem_raw);
  const uint32_t base = (raw + 1023) & ~1023u;  // the swizzle pattern repeats every 1024 bytes
  unsigned char* const sbase = smem_raw + (base - raw);
  const uint32_t bars = base + kBarOff;
  const Smem sm{base,
                base + kRingOff,
                bars,
                bars + 8 * kStages,
                bars + 16 * kStages,
                bars + 16 * kStages + 8,
                bars + 16 * kStages + 16,
                reinterpret_cast<float*>(sbase + kWsOff),
                reinterpret_cast<float*>(sbase + kLnOff),
                reinterpret_cast<float*>(sbase + kRedOff),
                reinterpret_cast<float*>(sbase + kXRedOff)};
  const int tid = threadIdx.x, rank = static_cast<int>(cluster_rank());
  if (tid == 0) {
#pragma unroll
    for (int s = 0; s < kStages; ++s) {
      mbar_init(sm.full + 8 * s, 1);
      mbar_init(sm.empty + 8 * s, 2);  // both warpgroups read every stage
    }
    mbar_init(sm.a_full, 1);
    mbar_init(sm.a_empty, 2);
#pragma unroll
    for (int x = 0; x < 3; ++x) mbar_init(sm.xbar + 8 * x, kCluster * kBM);  // both blocks' rows
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  for (int i = tid; i < p.k * kC; i += kThreads) sm.ws[i] = p.ws[i];
  for (int i = tid; i < kC; i += kThreads) sm.ln[i] = p.gamma[i], sm.ln[kC + i] = p.beta[i];
  __syncthreads();
  cluster_sync();  // the other block's barriers are set up

  // The launch bound leaves 168 registers a thread; the producer gives most
  // of its warpgroup's back to the consumers' sum and accumulators.
  if (tid >= kConsumers) {
    asm volatile("setmaxnreg.dec.sync.aligned.u32 40;\n" ::: "memory");
    if (tid == kConsumers) produce(maps, p, sm, rank);
  } else {
    asm volatile("setmaxnreg.inc.sync.aligned.u32 232;\n" ::: "memory");
    consume(p, sm, rank);
  }
  cluster_sync();  // no block leaves while the other may still write to it
}

}  // namespace

// Dynamic shared memory of a block and blocks resident per SM.
extern "C" int s3_int8_conv_occupancy(int* smem_bytes, int* blocks_per_sm) {
  *smem_bytes = kSmemBytes;
  cudaError_t err = cudaFuncSetAttribute(int8_conv_kernel,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize, kSmemBytes);
  if (err == cudaSuccess)
    err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(blocks_per_sm, int8_conv_kernel,
                                                        kThreads, kSmemBytes);
  return static_cast<int>(err);
}

// xq [B, T, 512] int8, xs [B, T] f32, wq [k, 512, 512] int8, ws [k, 512] f32,
// gamma / beta [512] f32 -> out [B, T', 512] (see the top of the file): int8
// codes with scale [B, T'] f32, or when scale is null rows in f32 (out_f32)
// or bf16. sum_out / stats_out: the test mode's tap sum and LN statistics,
// or null.
extern "C" int s3_int8_conv(const void* xq, const void* xs, const void* wq, const void* ws,
                            const void* gamma, const void* beta, int B, int T, int t_out, int k,
                            void* out, void* scale, int out_f32, void* sum_out, void* stats_out,
                            void* stream) {
  if (B <= 0 || t_out <= 0 || k < 2 || k > kMaxTaps || 2 * (t_out - 1) + k > T ||
      (sum_out == nullptr) != (stats_out == nullptr))
    return static_cast<int>(cudaErrorInvalidValue);
  Maps maps;
  const cuuint64_t dims[3] = {kC, static_cast<cuuint64_t>(t_out), static_cast<cuuint64_t>(B)};
  const cuuint64_t strides[2] = {2 * kC, static_cast<cuuint64_t>(T) * kC};
  const cuuint32_t box[3] = {kBK, kBM, 1};
  cudaError_t err = cudaSuccess;
  for (int t = 0; t < kMaxTaps && err == cudaSuccess; ++t)
    err = swizzled_map(&maps.a[t], CU_TENSOR_MAP_DATA_TYPE_UINT8, 3,
                       static_cast<const char*>(xq) + (t < k ? t : 0) * kC, dims, strides, box);
  const cuuint64_t w_dims[2] = {kC, static_cast<cuuint64_t>(k) * kC};
  const cuuint64_t w_strides[1] = {kC};
  const cuuint32_t w_box[2] = {kBK, kNB};
  if (err == cudaSuccess)
    err = swizzled_map(&maps.w, CU_TENSOR_MAP_DATA_TYPE_UINT8, 2, wq, w_dims, w_strides, w_box);
  if (err == cudaSuccess)
    err = cudaFuncSetAttribute(int8_conv_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                               kSmemBytes);
  cudaLaunchConfig_t cfg = {};
  cudaLaunchAttribute attr;
  attr.id = cudaLaunchAttributeClusterDimension;
  attr.val.clusterDim.x = kCluster;
  attr.val.clusterDim.y = 1;
  attr.val.clusterDim.z = 1;
  cfg.gridDim = dim3(kCluster);
  cfg.blockDim = dim3(kThreads);
  cfg.dynamicSmemBytes = kSmemBytes;
  cfg.stream = static_cast<cudaStream_t>(stream);
  cfg.attrs = &attr;
  cfg.numAttrs = 1;
  int clusters = 0;
  if (err == cudaSuccess) err = cudaOccupancyMaxActiveClusters(&clusters, int8_conv_kernel, &cfg);
  if (err == cudaSuccess && clusters < 1) err = cudaErrorInvalidConfiguration;
  if (err != cudaSuccess) return static_cast<int>(err);
  const int m_tiles = (t_out + kBM - 1) / kBM, tiles = B * m_tiles;
  const Params p{static_cast<const float*>(xs),    static_cast<const float*>(ws),
                 static_cast<const float*>(gamma), static_cast<const float*>(beta),
                 T, t_out, k, m_tiles, tiles, out, static_cast<float*>(scale), out_f32,
                 static_cast<float*>(sum_out),     static_cast<float*>(stats_out)};
  cfg.gridDim = dim3(kCluster * (tiles < clusters ? tiles : clusters));
  err = cudaLaunchKernelEx(&cfg, int8_conv_kernel, maps, p);
  return static_cast<int>(err != cudaSuccess ? err : cudaGetLastError());
}
