// The int8 projections of K1 `fused_attention_block`, K12
// `fused_int8_linear` and K6's out-proj as one kernel: a block keeps a panel
// of up to 128 whole rows of its input on chip, quantizes it there, and runs
// the panel against the int8 weight with the dequantizing epilogue overlapped:
//   out[m, n] = epilogue(sum_k q[m, k] * w[n, k], rs[m], cs[n], bias[n][, res[m, n]])
// x [M, C] bf16, or f32 for K6's context (C <= 1,024, a multiple of 16), w
// [N, C] int8 codes with per-output-channel scales cs [N] (nn.Linear
// layout), bias [N] f32.
//
// Replaces, on the card, what the Pallas kernels compute in their cells:
//   - `fused_attention_block` (s3prl_tpu/kernels/flash_attention.py:664,
//     pallas_call at :633): the LN prologue and row quantization of x
//     (:512-531) with the QKV product and its three bf16 roundings (kQkv,
//     :537-544), and the bf16 context quantization (:605-611) with the
//     out-proj, scale, bias and residual in f32 (kLinear, :612-617; f32 out
//     when the postnorm LN follows, then layernorm.cu);
//   - `fused_int8_linear` (s3prl_tpu/kernels/ffn.py:238, pallas_call at
//     :216): [LN ->] row quantization -> int8 GEMM -> + b [+ residual]
//     (kLinear, :185-197);
//   - `fused_qkv_attention_outproj` (s3prl_tpu/kernels/flash_attention.py:
//     338, pallas_call at :312): the f32 context's row quantization
//     (:287-289) and the out-proj ((f32(acc) * s) * wos + bo) + residual
//     (kLinear, :290-294), on f32 rows (the third instantiation).
// Wider rows (C > 1,024) do not fit the panel; the wrappers send them to
// quant_rows.cu + gemm_s8.cu by shape (`PANEL_MAX_C`, kernels/_common.py).
//
// The two row rules of quant_rows.cu, operation for operation:
//   f32 (quant_rows_kernel; `quantize_rows` on the CPU; bf16 or f32 rows,
//     the LN on bf16 rows only): [v = LN(x) in f32,
//     1 / sqrtf IEEE-rounded, the affine as (x - mean) * rstd * g + b in
//     __fmul_rn / __fadd_rn ->] s = max(absmax, 1e-8) / 127, q =
//     clip(rint(v / s)), true division;
//   ctx (quant_rows_bf16_kernel; `quantize_context_reference`): s =
//     bf16(max(absmax, bf16(1e-6)) / 127), q = clip(rint(bf16(x / s))).
// Without the LN, codes and scales equal the plain versions' bit for bit.
// The LN statistics are summed in another order (per lane over its 16-byte
// groups, then across the warp), so they can differ from another sum's in
// the last bit; given them, the codes and scales are again bit-equal.
// The codes never leave shared memory and the scales stay there too (with
// `q_out` set, a test mode also writes codes, scales and the LN statistics
// to device memory).
//
// Epilogues, with the cast points of gemm_s8.cu:
//   kQkv     out bf16 = bf16(bf16(bf16(acc) * bf16(rs[m] * cs[n])) + bf16(bias[n]));
//   kLinear  v = f32(acc) * rs[m] * cs[n] + bias[n] [+ f32(res[m, n])]; out bf16 or f32.
//
// Bound: at the main path's shapes (M = 15,968 rows, C = 1,024, N = 3,072
// or 1,024) the int8 tensor rate, 100.5 GOP for the QKV product. Every
// block streams all of w from L2 (125 panels x 3 MB = 393 MB for the QKV),
// and each wgmma m64n128k32 reads 6 KB of operands from shared memory for
// 0.5 MOP, near the SM's shared-memory rate. Design and the tile:
//   - Panel: 128 rows x 1,024 bytes of codes = 128 KB of shared memory, in
//     eight 128-byte K boxes of 128 rows in the 128-byte swizzle, the layout
//     the TMA A boxes of gemm_s8.cu have, so the wgmma descriptors of A point
//     straight into it (desc128). x is read once, 16 bytes a lane (a
//     1,024-wide bf16 row is 64 bytes a lane, held in registers), by all
//     twelve warps before the producer warpgroup gives its registers away,
//     two bf16 rows a warp in flight and the next two loaded before these
//     are quantized (f32 rows, 128 bytes a lane: one and the next one);
//     the LN scale and bias are staged in shared memory. Meanwhile the
//     producer thread has filled the ring's first stages.
//   - N tiles of 128 columns: a 128 x 128 x 128-byte W box is 16 KB, so a
//     four-stage TMA ring is 64 KB; with the panel 192 KB. A tile of 128
//     rows x 128 columns is two wgmma m64n128k32 a 32-byte K step, 128
//     int32 accumulators a thread, as gemm_s8.cu's 64 x 256 tiles have.
//     (Wider tiles would not leave room for the ring beside the panel.)
//   - Ping-pong: the two consumer warpgroups take the N tiles in turns
//     (warpgroup w takes tiles w, w + 2, ...). Their main loops run one at
//     a time in tile order, gated by two named barriers (the warpgroup of
//     tile j waits until the products of tile j - 1 are all issued), so one
//     warpgroup's epilogue overlaps the other's products. Gating the main
//     loops also keeps each ring stage's phase unambiguous: a warpgroup's
//     ring position skips the other's stages (the ring holds every tile's
//     stages in tile order), and when it waits on a stage, every stage
//     before it has been filled. Each `empty` barrier counts the one
//     warpgroup that read the stage.
//   - Epilogue: each tile's column scales and bias are staged in shared
//     memory once; each warp passes its accumulators through a 16 x 32
//     staging tile of its own (rows 144 bytes apart: the read-back is free of
//     bank conflicts) and reads them back as 8 consecutive columns a lane,
//     so the residual is read and the output written 16 bytes (f32: 32) a
//     lane, 64 (128) contiguous bytes a row. The residual is loaded a part
//     (64 rows x 64 columns) ahead, the first part's while the tile's last
//     products run: one load at a time per pass left each tile's epilogue
//     waiting out 16 round trips to device memory, longer than the other
//     warpgroup's main loop.
//   - Grid: one block per (panel, slice of the N tiles). Where the panels
//     are fewer than the SMs, each panel's N tiles are split into
//     min(SMs / panels, ceil(N tiles / 2)) contiguous slices, one block each
//     (every block of a panel recomputes its prologue: a 256 KB read, the
//     later ones mostly from L2); 125 panels (B=32 x 499) or 94 (B=8 x
//     1,499) take one block each.
// Shared memory: panel 128 KB + ring 64 KB + staging 18 KB + row scales,
// column scales and bias 2.5 KB + barriers + the LN affine 8 KB = 226,880
// bytes with the alignment slack: one block an SM, 384 threads (two
// consumer warpgroups and a producer warpgroup whose one thread issues
// every W load). A five-stage ring (with 16-column staging to make room)
// was no faster; the launch bound's 168 registers a thread hold the 128
// accumulators and at most 16 registers of residual in flight (32 spilled).
#include "hopper.cuh"

namespace {

using namespace s3;

enum Mode { kQkv = 1, kLinear = 2 };  // as gemm_s8.cu's
enum Rule { kRuleF32 = 0, kRuleCtx = 1 };

constexpr int kBM = 128;              // panel rows
constexpr int kMaxC = 1024;           // panel codes a row
constexpr int kBK = 128;              // bytes of K a panel box and a ring stage
constexpr int kBN = 128;              // columns of an N tile
constexpr int kStages = 4;
constexpr int kThreads = 384;         // two consumer warpgroups + the producer's
constexpr int kBox = kBM * kBK;       // 16 KB
constexpr int kWBox = kBN * kBK;      // 16 KB
constexpr int kCC = 32;               // columns a warp stages at a time
constexpr int kStgStride = kCC + 4;   // words a staging row
constexpr int kStgWarp = 16 * kStgStride * 4;
constexpr int kGroups = kMaxC / 256;  // 8-column groups a lane holds (columns 256 i + 8 lane)

constexpr int kRingOff = kBM * kMaxC;
constexpr int kStgOff = kRingOff + kStages * kWBox;
constexpr int kRsOff = kStgOff + 8 * kStgWarp;
constexpr int kColOff = kRsOff + kBM * 4;
constexpr int kBarOff = kColOff + 2 * 2 * kBN * 4;
constexpr int kLnOff = kBarOff + 2 * kStages * 8;  // the LN scale and bias, f32 [2, kMaxC]
constexpr int kSmemBytes = kLnOff + 2 * kMaxC * 4 + 1024;  // + alignment slack

// named barriers (0 is __syncthreads)
constexpr int kBarOrder = 1;     // + w: warpgroup w may start its next main loop
constexpr int kBarGroup = 3;     // + w: warpgroup w alone

struct Params {
  const void* x;       // [M, C] bf16, or f32 (the f32 rule without the LN)
  int M, C, rule;
  const float* gamma;  // LN scale [C] or null (the f32 rule only)
  const float* beta;
  float eps;
  int N, k_tiles, n_tiles, splits;
  const float* cs;
  const float* bias;
  const bf16* res;     // [M, N] or null (kLinear)
  void* out;           // [M, N]
  int out_f32;         // kLinear
  int8_t* q_out;       // test mode: codes [M, C], scales [M], LN statistics [M, 2]
  float* s_out;
  float* stats_out;
};

__device__ __forceinline__ void bar_arrive(int id, int n) {
  asm volatile("bar.arrive %0, %1;\n" ::"r"(id), "r"(n) : "memory");
}

__device__ __forceinline__ float bf16_round(float v) {
  return __bfloat162float(__float2bfloat16_rn(v));
}

// Byte offset in the panel of code (row r, column c), c a multiple of 8:
// box c / 128, the 16-byte chunk of row r permuted by the 128-byte swizzle.
__device__ __forceinline__ uint32_t panel_offset(int r, int c) {
  const int b = c % kBK;
  return (c / kBK) * kBox + r * kBK + ((((b >> 4) ^ (r & 7))) << 4) + (b & 15);
}

// One row of the panel, held by one warp: lane `lane` holds columns 256 i +
// 8 lane + e in v[8 i + e] (0 where the column is past C). Quantizes it by
// the row rule into codes at the lane's places in the panel, returns the
// scale; with q_out, writes codes, scale and statistics to device memory.
__device__ __forceinline__ float quantize_row(float (&v)[8 * kGroups], const Params& p,
                                              const float* affine, int lane, int r, long long m,
                                              unsigned char* panel, bool test) {
  const bool ln = p.gamma != nullptr;
  float mean = 0.f, rstd = 1.f;
  if (ln) {
    const float n = static_cast<float>(p.C);
    float s = 0.f;
#pragma unroll
    for (int i = 0; i < kGroups; ++i)
      if (256 * i + 8 * lane < p.C)
#pragma unroll
        for (int e = 0; e < 8; ++e) s += v[8 * i + e];
    mean = warp_sum(s) / n;
    float q = 0.f;
#pragma unroll
    for (int i = 0; i < kGroups; ++i)
      if (256 * i + 8 * lane < p.C)
#pragma unroll
        for (int e = 0; e < 8; ++e) {
          const float d = v[8 * i + e] - mean;
          q += d * d;
        }
    rstd = 1.f / sqrtf(warp_sum(q) / n + p.eps);
#pragma unroll
    for (int i = 0; i < kGroups; ++i) {
      const int c = 256 * i + 8 * lane;
      const bool in = c < p.C;
      float g[8], be[8];
      load8(affine + c, g);
      load8(affine + kMaxC + c, be);
#pragma unroll
      for (int e = 0; e < 8; ++e) {
        const int k = 8 * i + e;
        v[k] = in ? __fadd_rn(__fmul_rn(__fmul_rn(v[k] - mean, rstd), g[e]), be[e]) : 0.f;
      }
    }
  }
  float amax = 0.f;
#pragma unroll
  for (int k = 0; k < 8 * kGroups; ++k) amax = fmaxf(amax, fabsf(v[k]));
  amax = warp_max(amax);
  const bool ctx = p.rule == kRuleCtx;
  const float s = ctx ? bf16_round(fmaxf(amax, bf16_round(1e-6f)) / 127.f)
                      : fmaxf(amax, 1e-8f) / 127.f;
#pragma unroll
  for (int i = 0; i < kGroups; ++i) {
    uint32_t word[2];
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      uint32_t packed = 0;
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const float x = v[8 * i + 4 * h + e];
        const int8_t code = quant_code(ctx ? bf16_round(x / s) : x / s);
        packed |= static_cast<uint32_t>(static_cast<uint8_t>(code)) << (8 * e);
      }
      word[h] = packed;
    }
    const int c = 256 * i + 8 * lane;
    *reinterpret_cast<uint2*>(panel + panel_offset(r, c)) = make_uint2(word[0], word[1]);
    if (test && c < p.C)
      *reinterpret_cast<uint2*>(p.q_out + m * p.C + c) = make_uint2(word[0], word[1]);
  }
  if (test && lane == 0) {
    p.s_out[m] = s;
    if (ln) p.stats_out[2 * m] = mean, p.stats_out[2 * m + 1] = rstd;
  }
  return s;
}

// The prologue, on all twelve warps of the block: warp `warp` quantizes
// panel rows warp, warp + 12, ... into the panel and their scales into rs
// (rows past M get zero codes), Rows<TX>::kInFlight rows at a time, the next
// rows' loads issued before these rows' arithmetic: a lane holds 8 columns
// of each of the row's kGroups 256-column groups, one 16-byte load a group
// for bf16 rows and two for f32 rows (K6's f32 context), so both keep 32
// registers of raw rows in flight beside the 32 of the next ones (more
// spilled). `ln`: the LN scale and bias in shared memory.
template <typename TX>
struct Rows {
  static constexpr int kVecs = sizeof(TX) / 2;         // 16-byte loads per 8 columns
  static constexpr int kInFlight = 2 / kVecs;          // rows a warp loads at once
  static constexpr int kLoads = kGroups * kVecs;       // 16-byte loads a lane a row
};

template <typename TX>
__device__ __forceinline__ void load_rows(uint4 (&raw)[Rows<TX>::kInFlight][Rows<TX>::kLoads],
                                          const Params& p, int row0, int r0, int lane) {
  using R = Rows<TX>;
  constexpr int kWarps = kThreads / 32;
  const TX* x = static_cast<const TX*>(p.x);
#pragma unroll
  for (int t = 0; t < R::kInFlight; ++t) {
    const long long m = row0 + r0 + t * kWarps;
#pragma unroll
    for (int i = 0; i < R::kLoads; ++i) {
      const int c = 256 * (i / R::kVecs) + 8 * lane + 4 * (i % R::kVecs);
      raw[t][i] = r0 + t * kWarps < kBM && m < p.M && c < p.C
                      ? __ldg(reinterpret_cast<const uint4*>(x + m * p.C + c))
                      : make_uint4(0, 0, 0, 0);
    }
  }
}

// The 8 columns of group i of a row's raw loads as floats.
__device__ __forceinline__ void unpack8(const uint4* raw, float* v, const bf16*) {
  const __nv_bfloat162* h = reinterpret_cast<const __nv_bfloat162*>(raw);
#pragma unroll
  for (int e = 0; e < 4; ++e) {
    const float2 f = __bfloat1622float2(h[e]);
    v[2 * e] = f.x, v[2 * e + 1] = f.y;
  }
}
__device__ __forceinline__ void unpack8(const uint4* raw, float* v, const float*) {
  const float* f = reinterpret_cast<const float*>(raw);
#pragma unroll
  for (int e = 0; e < 8; ++e) v[e] = f[e];
}

template <typename TX>
__device__ __forceinline__ void prologue(const Params& p, int row0, int warp, int lane,
                                         unsigned char* panel, float* rs, const float* ln,
                                         bool test) {
  using R = Rows<TX>;
  constexpr int kWarps = kThreads / 32, kStep = R::kInFlight * kWarps;
  uint4 raw[R::kInFlight][R::kLoads], next[R::kInFlight][R::kLoads];
  load_rows<TX>(raw, p, row0, warp, lane);
  for (int r0 = warp; r0 < kBM; r0 += kStep) {
    if (r0 + kStep < kBM) load_rows<TX>(next, p, row0, r0 + kStep, lane);
#pragma unroll
    for (int t = 0; t < R::kInFlight; ++t) {
      const int r = r0 + t * kWarps;
      if (r >= kBM) continue;
      const long long m = row0 + r;
      float v[8 * kGroups];
#pragma unroll
      for (int i = 0; i < kGroups; ++i)
        unpack8(&raw[t][i * R::kVecs], v + 8 * i, static_cast<const TX*>(nullptr));
      if (m < p.M) {
        const float s = quantize_row(v, p, ln, lane, r, m, panel, test);
        if (lane == 0) rs[r] = s;
      } else {
#pragma unroll
        for (int i = 0; i < kGroups; ++i)
          *reinterpret_cast<uint2*>(panel + panel_offset(r, 256 * i + 8 * lane)) =
              make_uint2(0, 0);
      }
    }
#pragma unroll
    for (int t = 0; t < R::kInFlight; ++t)
#pragma unroll
      for (int i = 0; i < R::kLoads; ++i) raw[t][i] = next[t][i];
  }
}

// A tile's epilogue goes in parts: a 64-row half, kPartQ staging chunks of
// kCC columns. The residual a lane reads in one part (kLinear) is loaded
// before the part, all at once, so that its loads overlap (the first
// part's while the tile's last products run): for each chunk and each of
// kPasses passes, the 8 columns the lane stores (zeros outside [M, N)).
// More in flight would not fit beside the 128 accumulators.
constexpr int kLanesRow = kCC / 8;          // lanes that read back one staged row
constexpr int kRowsPass = 32 / kLanesRow;   // rows a pass reads back
constexpr int kPasses = 16 / kRowsPass;
constexpr int kPartQ = 2;                   // staging chunks a part
constexpr int kParts = kBN / kCC / kPartQ;  // parts a half
constexpr int kResLoads = kPartQ * kPasses;

__device__ __forceinline__ void load_residual(uint4 (&res)[kResLoads], const Params& p,
                                              int row0, int n0, int h, int part, int warp,
                                              int lane) {
#pragma unroll
  for (int dq = 0; dq < kPartQ; ++dq)
#pragma unroll
    for (int pp = 0; pp < kPasses; ++pp) {
      const long long m = row0 + h * 64 + warp * 16 + lane / kLanesRow + kRowsPass * pp;
      const int n = n0 + kCC * (part * kPartQ + dq) + 8 * (lane % kLanesRow);
      res[dq * kPasses + pp] =
          p.res != nullptr && m < p.M && n < p.N
              ? *reinterpret_cast<const uint4*>(p.res + static_cast<size_t>(m) * p.N + n)
              : make_uint4(0, 0, 0, 0);
    }
}

// One warp's share of one part of a tile's epilogue: rows 16 warp .. 16 warp
// + 15 of half h, through the warp's staging tile kCC columns at a time,
// read back 8 consecutive columns a lane.
template <int kMode>
__device__ __forceinline__ void epilogue_part(const int (&acc)[64], const uint4 (&res)[kResLoads],
                                              const Params& p, int row0, int n0, int h, int part,
                                              int warp, int lane, int* stg, const float* rs,
                                              const float* colp) {
  const int fr = lane / 4, cq = 2 * (lane % 4);
#pragma unroll
  for (int dq = 0; dq < kPartQ; ++dq) {
    const int q = part * kPartQ + dq;
    if (n0 + kCC * q >= p.N) continue;  // warp-uniform
    __syncwarp();
#pragma unroll
    for (int cc = 0; cc < kCC / 8; ++cc) {
      const int c = (kCC / 8) * q + cc;  // 8-column chunk of the fragment
      *reinterpret_cast<int2*>(stg + fr * kStgStride + 8 * cc + cq) =
          make_int2(acc[4 * c], acc[4 * c + 1]);
      *reinterpret_cast<int2*>(stg + (fr + 8) * kStgStride + 8 * cc + cq) =
          make_int2(acc[4 * c + 2], acc[4 * c + 3]);
    }
    __syncwarp();
#pragma unroll
    for (int pp = 0; pp < kPasses; ++pp) {
      const int lr = lane / kLanesRow + kRowsPass * pp, col = kCC * q + 8 * (lane % kLanesRow);
      const int pr = h * 64 + warp * 16 + lr;
      const long long m = row0 + pr;
      const int n = n0 + col;
      if (m >= p.M || n >= p.N) continue;
      const int* src = stg + lr * kStgStride + 8 * (lane % kLanesRow);
      const int4 s0 = *reinterpret_cast<const int4*>(src);
      const int4 s1 = *reinterpret_cast<const int4*>(src + 4);
      const int s[8] = {s0.x, s0.y, s0.z, s0.w, s1.x, s1.y, s1.z, s1.w};
      float cs[8], bias[8], v[8];
      const float4* cp = reinterpret_cast<const float4*>(colp + col);
      const float4* bp = reinterpret_cast<const float4*>(colp + kBN + col);
      const float4 c0 = cp[0], c1 = cp[1], b0 = bp[0], b1 = bp[1];
      cs[0] = c0.x, cs[1] = c0.y, cs[2] = c0.z, cs[3] = c0.w;
      cs[4] = c1.x, cs[5] = c1.y, cs[6] = c1.z, cs[7] = c1.w;
      bias[0] = b0.x, bias[1] = b0.y, bias[2] = b0.z, bias[3] = b0.w;
      bias[4] = b1.x, bias[5] = b1.y, bias[6] = b1.z, bias[7] = b1.w;
      const float rsm = rs[pr];
      const size_t off = static_cast<size_t>(m) * p.N + n;
      if constexpr (kMode == kQkv) {
#pragma unroll
        for (int e = 0; e < 8; ++e) {
          const float accb = __bfloat162float(__int2bfloat16_rn(s[e]));
          const float sc = bf16_round(__fmul_rn(rsm, cs[e]));
          v[e] = __fadd_rn(bf16_round(__fmul_rn(accb, sc)), bf16_round(bias[e]));
        }
        store8(static_cast<bf16*>(p.out) + off, v);  // the third rounding
      } else {
        const __nv_bfloat162* rh =
            reinterpret_cast<const __nv_bfloat162*>(&res[dq * kPasses + pp]);
#pragma unroll
        for (int e = 0; e < 8; ++e) {
          v[e] = __fadd_rn(__fmul_rn(__fmul_rn(static_cast<float>(s[e]), rsm), cs[e]), bias[e]);
          if (p.res != nullptr) {
            const float2 r = __bfloat1622float2(rh[e / 2]);
            v[e] = __fadd_rn(v[e], e % 2 ? r.y : r.x);
          }
        }
        if (p.out_f32)
          store8(static_cast<float*>(p.out) + off, v);
        else
          store8(static_cast<bf16*>(p.out) + off, v);
      }
    }
  }
}

template <int kMode, typename TX>
__global__ void __launch_bounds__(kThreads, 1)
    int8_panel_kernel(const __grid_constant__ CUtensorMap tm_w, const Params p) {
  extern __shared__ unsigned char smem_raw[];
  const uint32_t raw = smem_u32(smem_raw);
  const uint32_t base = (raw + 1023) & ~1023u;  // the swizzle pattern repeats every 1024 bytes
  unsigned char* const sbase = smem_raw + (base - raw);
  unsigned char* const panel = sbase;
  const uint32_t panel_s = base, ring = base + kRingOff;
  const uint32_t full = base + kBarOff, empty = full + 8 * kStages;
  float* const rs = reinterpret_cast<float*>(sbase + kRsOff);
  float* const ln = reinterpret_cast<float*>(sbase + kLnOff);
  const int tid = threadIdx.x, lane = tid % 32;
  const int row0 = (blockIdx.x / p.splits) * kBM, split = blockIdx.x % p.splits;
  const int t_begin = split * p.n_tiles / p.splits;
  const int nt = (split + 1) * p.n_tiles / p.splits - t_begin;  // this block's N tiles
  const int stages = nt * p.k_tiles;  // the ring holds every W box of the block's tiles in order
  // The producer thread: stages [from, to), each into its slot once the
  // warpgroup that read the slot's last stage has handed it back.
  auto produce = [&](int from, int to) {
    for (int it = from; it < to; ++it) {
      const int s = it % kStages, kt = it % p.k_tiles;
      mbar_wait(empty + 8 * s, ((it / kStages) & 1) ^ 1);  // a fresh ring passes
      mbar_expect_tx(full + 8 * s, kWBox);
      tma_load_2d(ring + s * kWBox, &tm_w, kt * kBK, (t_begin + it / p.k_tiles) * kBN,
                  full + 8 * s);
    }
  };
  if (tid == 0) {
#pragma unroll
    for (int s = 0; s < kStages; ++s) {
      mbar_init(full + 8 * s, 1);
      mbar_init(empty + 8 * s, 1);  // the one warpgroup that read the stage
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  if (p.gamma != nullptr)
    for (int c = tid; c < p.C; c += kThreads) ln[c] = p.gamma[c], ln[kMaxC + c] = p.beta[c];
  __syncthreads();
  const int first = stages < kStages ? stages : kStages;
  if (tid == 256) produce(0, first);  // the ring fills while the panel is quantized

  prologue<TX>(p, row0, tid / 32, lane, panel, rs, ln, p.q_out != nullptr && split == 0);
  fence_async_shared();
  __syncthreads();

  // The launch bound leaves 168 registers a thread; the producer gives most
  // of its warpgroup's back, so the consumers' 128 accumulators fit in 232.
  if (tid >= 256) {
    asm volatile("setmaxnreg.dec.sync.aligned.u32 40;\n" ::: "memory");
    if (tid == 256) produce(first, stages);
    return;
  }

  asm volatile("setmaxnreg.inc.sync.aligned.u32 232;\n" ::: "memory");
  const int wg = tid / 128, warp = (tid % 128) / 32;
  const bool signals = tid % 128 == 0;  // hands the warpgroup's stages back
  float* const colp = reinterpret_cast<float*>(sbase + kColOff) + wg * 2 * kBN;
  int* const stg = reinterpret_cast<int*>(sbase + kStgOff) + (wg * 4 + warp) * (kStgWarp / 4);
  int acc[2][64];
  uint4 res[kResLoads];
  for (int j = wg; j < nt; j += 2) {
    const int n0 = (t_begin + j) * kBN;
    bar_sync(kBarGroup + wg, 128);  // the last tile's epilogue has read colp
    {
      const int n = n0 + tid % 128;
      colp[tid % 128] = n < p.N ? p.cs[n] : 0.f;
      colp[kBN + tid % 128] = n < p.N ? p.bias[n] : 0.f;
    }
    if (j > 0) bar_sync(kBarOrder + wg, 256);  // tile j - 1's products are issued
    int it = j * p.k_tiles;  // the ring position of this tile's first stage
    for (int kt = 0; kt < p.k_tiles; ++kt, ++it) {
      const int s = it % kStages;
      mbar_wait(full + 8 * s, (it / kStages) & 1);
      const uint32_t a_s = panel_s + kt * kBox, w_s = ring + s * kWBox;
      wg_fence();
#pragma unroll
      for (int kk = 0; kk < kBK / 32; ++kk) {
        const int accumulate = kt > 0 || kk > 0;
        wgmma_n128(acc[0], desc128(a_s + 32 * kk), desc128(w_s + 32 * kk), accumulate);
        wgmma_n128(acc[1], desc128(a_s + 64 * kBK + 32 * kk), desc128(w_s + 32 * kk),
                   accumulate);
      }
      wg_commit();
      wg_wait_one();  // the stage before this one is consumed
      if (kt > 0 && signals) mbar_arrive(empty + 8 * ((it - 1) % kStages));
    }
    if (j + 1 < nt) bar_arrive(kBarOrder + (wg ^ 1), 256);  // the other may start tile j + 1
    if constexpr (kMode == kLinear) load_residual(res, p, row0, n0, 0, 0, warp, lane);
    wg_wait_all();
    fence_regs(acc[0]);
    fence_regs(acc[1]);
    if (signals) mbar_arrive(empty + 8 * ((it - 1) % kStages));
    bar_sync(kBarGroup + wg, 128);  // colp is written
#pragma unroll
    for (int h = 0; h < 2; ++h)
#pragma unroll
      for (int part = 0; part < kParts; ++part) {
        if constexpr (kMode == kLinear)
          if (h > 0 || part > 0) load_residual(res, p, row0, n0, h, part, warp, lane);
        epilogue_part<kMode>(acc[h], res, p, row0, n0, h, part, warp, lane, stg, rs, colp);
      }
  }
}

template <int kMode, typename TX>
int launch(const CUtensorMap& tm_w, const Params& p, int grid, cudaStream_t stream) {
  auto kernel = int8_panel_kernel<kMode, TX>;
  const cudaError_t err =
      cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, kSmemBytes);
  if (err != cudaSuccess) return static_cast<int>(err);
  kernel<<<grid, kThreads, kSmemBytes, stream>>>(tm_w, p);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// Dynamic shared memory of a block and blocks resident per SM (the kLinear
// instantiation on bf16 rows; the three share their layout).
extern "C" int s3_int8_panel_occupancy(int* smem_bytes, int* blocks_per_sm) {
  *smem_bytes = kSmemBytes;
  auto kernel = int8_panel_kernel<kLinear, bf16>;
  cudaError_t err =
      cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, kSmemBytes);
  if (err == cudaSuccess)
    err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(blocks_per_sm, kernel, kThreads,
                                                        kSmemBytes);
  return static_cast<int>(err);
}

// x [M, C] bf16 (or f32 with x_is_f32: the f32 rule without the LN, kLinear)
// -> out [M, N] (see the top of the file). rule: 0 f32 (the LN prologue when
// gamma is given), 1 ctx. mode: 1 kQkv, 2 kLinear. q_out / s_out /
// stats_out: the test mode's codes, scales and LN statistics, or null.
extern "C" int s3_int8_panel(const void* x, int x_is_f32, int M, int C, int rule,
                             const void* gamma,
                             const void* beta, float eps, const void* w, int N, const void* cs,
                             const void* bias, const void* res, void* out, int mode, int out_f32,
                             void* q_out, void* s_out, void* stats_out, void* stream) {
  if (M <= 0 || C <= 0 || C > kMaxC || C % 16 || N <= 0 || N % 8 ||
      (rule != kRuleF32 && rule != kRuleCtx) || (rule == kRuleCtx && gamma != nullptr) ||
      (x_is_f32 && (rule != kRuleF32 || gamma != nullptr || mode != kLinear)))
    return static_cast<int>(cudaErrorInvalidValue);
  CUtensorMap tm_w;
  const cuuint64_t dims[2] = {static_cast<cuuint64_t>(C), static_cast<cuuint64_t>(N)};
  const cuuint64_t strides[1] = {static_cast<cuuint64_t>(C)};
  const cuuint32_t box[2] = {kBK, kBN};
  cudaError_t err = swizzled_map(&tm_w, CU_TENSOR_MAP_DATA_TYPE_UINT8, 2, w, dims, strides, box);
  int sms = 0;
  if (err == cudaSuccess) err = sm_count(&sms);
  if (err != cudaSuccess) return static_cast<int>(err);
  const int panels = (M + kBM - 1) / kBM, n_tiles = (N + kBN - 1) / kBN;
  const int fit = sms / panels, pairs = (n_tiles + 1) / 2;
  const int splits = fit < 1 ? 1 : (fit < pairs ? fit : pairs);
  const Params p{x, M, C, rule,
                 static_cast<const float*>(gamma), static_cast<const float*>(beta), eps,
                 N, (C + kBK - 1) / kBK, n_tiles, splits,
                 static_cast<const float*>(cs), static_cast<const float*>(bias),
                 static_cast<const bf16*>(res), out, out_f32,
                 static_cast<int8_t*>(q_out), static_cast<float*>(s_out),
                 static_cast<float*>(stats_out)};
  auto s = static_cast<cudaStream_t>(stream);
  switch (mode) {
    case kQkv: return launch<kQkv, bf16>(tm_w, p, panels * splits, s);
    case kLinear:
      return x_is_f32 ? launch<kLinear, float>(tm_w, p, panels * splits, s)
                      : launch<kLinear, bf16>(tm_w, p, panels * splits, s);
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}
