// Hopper (sm_90a) building blocks shared by the wgmma kernels
// (gated_attention.cu, gemm_s8.cu, gemm_bf16.cu, int8_panel.cu,
// int8_conv.cu, posconv.cu): mbarriers, TMA tensor-map loads, the
// 128-byte-swizzle and unswizzled wgmma descriptors, named barriers and the
// async-proxy fence, the wgmma fences and products, the
// host-side cuTensorMapEncodeTiled lookup, the persistent GEMM skeleton that
// the int8 and bf16 GEMMs share (namespace s3::gemm), and the int8 product
// on 128-column tiles (at the end).
#pragma once

#include <cuda.h>

#include <numeric>

#include "common.cuh"

namespace s3 {

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ void mbar_init(uint32_t bar, int count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" ::"r"(bar), "r"(count) : "memory");
}
__device__ __forceinline__ void mbar_expect_tx(uint32_t bar, int bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::"r"(bar), "r"(bytes)
               : "memory");
}
__device__ __forceinline__ void mbar_arrive(uint32_t bar) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];\n" ::"r"(bar) : "memory");
}
// Spins until the phase of parity `parity` has completed (a fresh barrier
// counts its phase of parity 1 as completed).
__device__ __forceinline__ void mbar_wait(uint32_t bar, int parity) {
  uint32_t done = 0;
  while (!done) {
    asm volatile(
        "{\n.reg .pred p;\nmbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
        "selp.u32 %0, 1, 0, p;\n}\n"
        : "=r"(done)
        : "r"(bar), "r"(parity)
        : "memory");
  }
}

// One box of a 2-D / 3-D tensor map at coordinates (c0 innermost, ...) into
// shared memory at dst, completing on bar; elements outside the tensor
// (negative coordinates included) read as 0.
__device__ __forceinline__ void tma_load_2d(uint32_t dst, const CUtensorMap* map, int c0, int c1,
                                            uint32_t bar) {
  asm volatile(
      "cp.async.bulk.tensor.2d.shared::cluster.global.mbarrier::complete_tx::bytes"
      " [%0], [%1, {%2, %3}], [%4];\n" ::"r"(dst),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(c0), "r"(c1), "r"(bar)
      : "memory");
}
__device__ __forceinline__ void tma_load_3d(uint32_t dst, const CUtensorMap* map, int c0, int c1,
                                            int c2, uint32_t bar) {
  asm volatile(
      "cp.async.bulk.tensor.3d.shared::cluster.global.mbarrier::complete_tx::bytes"
      " [%0], [%1, {%2, %3, %4}], [%5];\n" ::"r"(dst),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(c0), "r"(c1), "r"(c2), "r"(bar)
      : "memory");
}

// `bytes` (<= the copy size) are read, the rest of the copy is zero-filled.
__device__ __forceinline__ void cp_async16_zfill(uint32_t dst, const void* src, int bytes) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(dst), "l"(src), "r"(bytes)
               : "memory");
}
__device__ __forceinline__ void cp_async4_zfill(uint32_t dst, const void* src, int bytes) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n" ::"r"(dst), "l"(src), "r"(bytes)
               : "memory");
}
// The barrier counts one arrival of this thread when its cp.asyncs land.
__device__ __forceinline__ void cp_async_arrive(uint32_t bar) {
  asm volatile("cp.async.mbarrier.arrive.noinc.shared::cta.b64 [%0];\n" ::"r"(bar) : "memory");
}

// wgmma shared-memory descriptor of a tile of 128-byte rows in the 128-byte
// swizzle (1024-byte aligned tile base): 8-row groups 1024 bytes apart. The
// same stride in both offset fields serves K-major tiles (where the leading
// offset is unused; a K step of 32 bytes advances the start address) and an
// MN-major tile of 64 bf16 columns (one swizzle atom along N, 8-row groups
// 1024 bytes apart).
__device__ __forceinline__ uint64_t desc128(uint32_t addr) {
  return static_cast<uint64_t>((addr & 0x3FFFF) >> 4) | (64ull << 16) | (64ull << 32) |
         (1ull << 62);
}

// wgmma shared-memory descriptor of a K-major tile without swizzle: core
// matrices of 8 rows x 16 bytes, each 128 contiguous bytes, `lbo` bytes
// between the two core matrices along K (the 16-byte halves of a 32-byte K
// step) and `sbo` between 8-row groups along M or N. The start address needs
// only 16-byte alignment, so a tile can begin at any row of a layout whose
// 16-byte chunks of K are stored as columns of rows (posconv.cu's window).
__device__ __forceinline__ uint64_t desc_plain(uint32_t addr, uint32_t lbo, uint32_t sbo) {
  return static_cast<uint64_t>((addr & 0x3FFFF) >> 4) | (static_cast<uint64_t>(lbo >> 4) << 16) |
         (static_cast<uint64_t>(sbo >> 4) << 32);
}

// Named barrier `id` (0 is __syncthreads) of n threads.
__device__ __forceinline__ void bar_sync(int id, int n) {
  asm volatile("bar.sync %0, %1;\n" ::"r"(id), "r"(n) : "memory");
}
// Orders this thread's shared-memory stores before later reads of the async
// proxy (wgmma operands, TMA stores).
__device__ __forceinline__ void fence_async_shared() {
  asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
}

__device__ __forceinline__ void wg_fence() {
  asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
}
__device__ __forceinline__ void wg_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
}
__device__ __forceinline__ void wg_wait_all() {
  asm volatile("wgmma.wait_group.sync.aligned 0;\n" ::: "memory");
}
// Waits until at most one committed group of this warpgroup is in flight.
__device__ __forceinline__ void wg_wait_one() {
  asm volatile("wgmma.wait_group.sync.aligned 1;\n" ::: "memory");
}
// Keeps the compiler from moving accesses of registers across the
// asynchronous products that own them.
template <int N>
__device__ __forceinline__ void fence_regs(float (&d)[N]) {
#pragma unroll
  for (int i = 0; i < N; ++i) asm volatile("" : "+f"(d[i])::"memory");
}
template <int N>
__device__ __forceinline__ void fence_regs(int (&d)[N]) {
#pragma unroll
  for (int i = 0; i < N; ++i) asm volatile("" : "+r"(d[i])::"memory");
}

#define S3_ACC32                                                                             \
  "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, %16, %17, %18, " \
  "%19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31}"
#define S3_OUT32(d)                                                                            \
  "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]),        \
      "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), \
      "+f"(d[14]), "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),           \
      "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]), "+f"(d[25]),           \
      "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31])

// d (+)= A B, A [64, 16] and B [16, 64] K-major in shared memory (bf16 in,
// f32 accumulate)
__device__ __forceinline__ void wgmma_ss(float (&d)[32], uint64_t a, uint64_t b, int accumulate) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %34, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 " S3_ACC32
      ", %32, %33, p, 1, 1, 0, 0;\n}\n"
      : S3_OUT32(d)
      : "l"(a), "l"(b), "r"(accumulate));
}

// d += A B, A [64, 16] bf16 in registers (the m64nNk16 A fragment), B [16,
// 64] in shared memory, MN-major (kTransB = 1: stored [K rows, 64 N]) or
// K-major (kTransB = 0: stored [64 N rows, K])
template <int kTransB>
__device__ __forceinline__ void wgmma_rs(float (&d)[32], const uint32_t (&a)[4], uint64_t b) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %37, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 " S3_ACC32
      ", {%32, %33, %34, %35}, %36, p, 1, 1, %38;\n}\n"
      : S3_OUT32(d)
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(b), "r"(1), "n"(kTransB));
}

// ---- host side ----

using EncodeTiled = CUresult (*)(CUtensorMap*, CUtensorMapDataType, cuuint32_t, void*,
                                 const cuuint64_t*, const cuuint64_t*, const cuuint32_t*,
                                 const cuuint32_t*, CUtensorMapInterleave, CUtensorMapSwizzle,
                                 CUtensorMapL2promotion, CUtensorMapFloatOOBfill);

// cuTensorMapEncodeTiled (a libcuda entry), reached through the runtime's
// entry-point query, so the library needs no link against libcuda.
inline EncodeTiled encode_tiled() {
  static const EncodeTiled fn = [] {
    void* p = nullptr;
    cudaDriverEntryPointQueryResult found;
#if CUDART_VERSION >= 12050
    const cudaError_t err = cudaGetDriverEntryPointByVersion("cuTensorMapEncodeTiled", &p, 12000,
                                                             cudaEnableDefault, &found);
#else
    const cudaError_t err =
        cudaGetDriverEntryPoint("cuTensorMapEncodeTiled", &p, cudaEnableDefault, &found);
#endif
    return err == cudaSuccess && found == cudaDriverEntryPointSuccess
               ? reinterpret_cast<EncodeTiled>(p)
               : nullptr;
  }();
  return fn;
}

// A tensor map of `rank` dimensions (dims innermost first, strides in bytes
// of dims 1..), boxes of `box` elements in the 128-byte swizzle, elements
// outside the tensor read as 0. cudaSuccess, or the error to return.
inline cudaError_t swizzled_map(CUtensorMap* map, CUtensorMapDataType type, int rank,
                                const void* base, const cuuint64_t* dims,
                                const cuuint64_t* strides, const cuuint32_t* box) {
  const EncodeTiled encode = encode_tiled();
  if (encode == nullptr) return cudaErrorNotSupported;
  const cuuint32_t unit[3] = {1, 1, 1};
  return encode(map, type, rank, const_cast<void*>(base), dims, strides, box, unit,
                CU_TENSOR_MAP_INTERLEAVE_NONE, CU_TENSOR_MAP_SWIZZLE_128B,
                CU_TENSOR_MAP_L2_PROMOTION_L2_128B,
                CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) == CUDA_SUCCESS
             ? cudaSuccess
             : cudaErrorInvalidValue;
}

// The SMs of the current device (persistent grids).
inline cudaError_t sm_count(int* n) {
  int dev = 0;
  const cudaError_t err = cudaGetDevice(&dev);
  return err != cudaSuccess ? err
                            : cudaDeviceGetAttribute(n, cudaDevAttrMultiProcessorCount, dev);
}


// ---- the persistent GEMM of gemm_s8.cu (int8) and gemm_bf16.cu (bf16) ----
//
//   acc[m, n] = sum_k a[m, k] * w[n, k]
// a [M, K] in row groups: row m = (g, r) = (m / a_rows, m % a_rows) starts
// a_gstride elements after group g - 1's and lda after row r - 1 (one group
// of M rows is a plain matrix; a stride-2 conv reads its rows straight from
// x [B, T, C] as B groups of T' rows with lda = 2C), w [N, K] row-major with
// row stride ldw (nn.Linear layout).
//
// A persistent grid (one block per SM) walks output tiles of 128 rows x 256
// columns, columns fastest, so the blocks in flight share their A rows and
// the weights stay in L2. A row tile is 128 rows of one row group: no box
// crosses from one utterance into the next. One producer thread keeps a ring
// of four stages full by TMA; a stage is 128 bytes of K (128 int8 or 64
// bf16): a 128-row A box (16 KB) and a 256-row W box (32 KB) in the 128-byte
// swizzle that wgmma reads, from tensor maps whose bounds zero-fill the
// ragged M, N and K edges. Two consumer warpgroups each own 64 rows of the
// tile and issue four wgmma m64n256 of 32 bytes of K a stage (k32 int8,
// k16 bf16) into 128 accumulators a thread; a stage is handed back to the
// producer once the products after it are issued and its own have completed
// (wait_group 1). The producer's warpgroup gives its registers to them
// (setmaxnreg 40 / 232). The producer runs ahead into the next tile while
// the consumers apply their file's epilogue straight from the registers.
//
// A's maps: one 3-D map (a run of `tap` elements of K, rows of a group,
// groups) per tap. Rows that do not overlap (lda >= K) are one tap of K
// elements. Rows that overlap (a k = 3 conv's im2col rows: K = 3C, lda = 2C)
// are split into K / tap runs of tap = gcd(lda, K) elements, each map based
// at its run, so that no map's rows overlap (a map whose row stride is below
// its row's extent need not be accepted by cuTensorMapEncodeTiled); tap is a
// multiple of a stage's K, so a stage never straddles two runs.
namespace gemm {

constexpr int kBM = 128, kBN = 256;  // tile rows, columns
constexpr int kStageK = 128;         // bytes of K a stage
constexpr int kStages = 4;
constexpr int kConsumers = 2;                     // warpgroups of 64 rows
constexpr int kThreads = (kConsumers + 1) * 128;  // + the producer warpgroup
constexpr int kATile = kBM * kStageK, kWTile = kBN * kStageK;
constexpr int kStageBytes = kATile + kWTile;  // 48 KB, a multiple of 1024
constexpr int kSmemBytes = kStages * kStageBytes + 2 * kStages * 8 + 1024;  // + alignment slack
constexpr int kMaxTaps = 3;

struct AMaps {
  CUtensorMap tap[kMaxTaps];
};

// Rows of a group, groups, N, K, the K elements of each A map, and the tile
// counts. The counts are set on the host (`shape`): between two tiles the
// consumers wait on nothing else, and dividing there again cost K13b's
// four-stage tiles 5% (PERF.md).
struct Shape {
  int a_rows, groups, N, K, tap, m_tiles, n_tiles, tiles;
};

struct Tile {
  int nt, g, r0;  // column tile, row group, first row in the group
};
__device__ __forceinline__ Tile tile_at(const Shape& sh, int tile) {
  const int mt = tile / sh.n_tiles;
  return {tile % sh.n_tiles, mt / sh.m_tiles, (mt % sh.m_tiles) * kBM};
}

// The ring (1024-byte aligned: the swizzle pattern repeats every 1024 bytes)
// and its barriers: full[s] completes when stage s has landed, empty[s] when
// both consumer warpgroups have handed it back. Every thread calls it.
struct Ring {
  uint32_t base, full, empty;
};
__device__ __forceinline__ Ring ring(const unsigned char* smem_raw) {
  const uint32_t base = (smem_u32(smem_raw) + 1023) & ~1023u;
  const Ring r{base, base + kStages * kStageBytes, base + kStages * kStageBytes + 8 * kStages};
  if (threadIdx.x == 0) {
#pragma unroll
    for (int s = 0; s < kStages; ++s) {
      mbar_init(r.full + 8 * s, 1);
      mbar_init(r.empty + 8 * s, kConsumers);
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();
  return r;
}

// The producer thread: every stage of every tile of this block, in order.
// kBK: elements of K a stage.
template <int kBK>
__device__ __forceinline__ void produce(const AMaps& a, const CUtensorMap& w, const Shape& sh,
                                        const Ring& r) {
  const int k_tiles = (sh.K + kBK - 1) / kBK;
  const bool one_tap = sh.tap == sh.K;
  int it = 0;
  for (int tile = blockIdx.x; tile < sh.tiles; tile += gridDim.x) {
    const Tile t = tile_at(sh, tile);
    for (int kt = 0; kt < k_tiles; ++kt, ++it) {
      const int s = it % kStages, k0 = kt * kBK;
      mbar_wait(r.empty + 8 * s, ((it / kStages) & 1) ^ 1);  // a fresh ring passes
      mbar_expect_tx(r.full + 8 * s, kStageBytes);
      const uint32_t dst = r.base + s * kStageBytes;
      if (one_tap)
        tma_load_3d(dst, &a.tap[0], k0, t.r0, t.g, r.full + 8 * s);
      else
        tma_load_3d(dst, &a.tap[k0 / sh.tap], k0 % sh.tap, t.r0, t.g, r.full + 8 * s);
      tma_load_2d(dst + kATile, &w, k0, t.nt * kBN, r.full + 8 * s);
    }
  }
}

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
#define S3_D8(c, d, i)                                                                         \
  c(d[i]), c(d[i + 1]), c(d[i + 2]), c(d[i + 3]), c(d[i + 4]), c(d[i + 5]), c(d[i + 6]),     \
      c(d[i + 7])
#define S3_OUT128(c, d)                                                                      \
  S3_D8(c, d, 0), S3_D8(c, d, 8), S3_D8(c, d, 16), S3_D8(c, d, 24), S3_D8(c, d, 32),       \
      S3_D8(c, d, 40), S3_D8(c, d, 48), S3_D8(c, d, 56), S3_D8(c, d, 64), S3_D8(c, d, 72), \
      S3_D8(c, d, 80), S3_D8(c, d, 88), S3_D8(c, d, 96), S3_D8(c, d, 104),                 \
      S3_D8(c, d, 112), S3_D8(c, d, 120)

// d (+)= A B over 32 bytes of K: A [64 rows, 32 bytes] and B [256 columns,
// 32 bytes], both K-major in shared memory. int8 (exact int32 sums) or bf16
// (f32 sums; a product of two bf16 values is exact in f32).
__device__ __forceinline__ void wgmma_n256(int (&d)[128], uint64_t a, uint64_t b,
                                           int accumulate) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %130, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n256k32.s32.s8.s8 " S3_ACC128 ", %128, %129, p;\n}\n"
      : S3_OUT128("+r", d)
      : "l"(a), "l"(b), "r"(accumulate));
}
__device__ __forceinline__ void wgmma_n256(float (&d)[128], uint64_t a, uint64_t b,
                                           int accumulate) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %130, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n256k16.f32.bf16.bf16 " S3_ACC128
      ", %128, %129, p, 1, 1, 0, 0;\n}\n"
      : S3_OUT128("+f", d)
      : "l"(a), "l"(b), "r"(accumulate));
}

// A consumer warpgroup's K loop over one tile: acc = its 64 rows x 256
// columns; `it` counts the stages consumed so far (the ring's position). The
// last stage is handed back once its products are done; acc is then final.
template <typename Acc>
__device__ __forceinline__ void consume(Acc (&acc)[128], const Ring& r, int wg, int k_tiles,
                                        int& it) {
  const bool signals = threadIdx.x % 128 == 0;  // hands the warpgroup's stages back
  for (int kt = 0; kt < k_tiles; ++kt, ++it) {
    const int s = it % kStages;
    mbar_wait(r.full + 8 * s, (it / kStages) & 1);
    const uint32_t a_s = r.base + s * kStageBytes + wg * 64 * kStageK;
    const uint32_t w_s = r.base + s * kStageBytes + kATile;
    wg_fence();
#pragma unroll
    for (int kk = 0; kk < kStageK / 32; ++kk)
      wgmma_n256(acc, desc128(a_s + 32 * kk), desc128(w_s + 32 * kk), kt > 0 || kk > 0);
    wg_commit();
    wg_wait_one();  // the stage before this one is consumed
    if (kt > 0 && signals) mbar_arrive(r.empty + 8 * ((it - 1) % kStages));
  }
  wg_wait_all();
  fence_regs(acc);
  if (signals) mbar_arrive(r.empty + 8 * ((it - 1) % kStages));
}

// ---- host side ----

// The problem's Shape for a [M, K] (M = groups x a_rows) by [N, K] product;
// `a_maps` sets its tap.
inline Shape shape(int a_rows, int M, int N, int K) {
  const int groups = M / a_rows, m_tiles = (a_rows + kBM - 1) / kBM,
            n_tiles = (N + kBN - 1) / kBN;
  return {a_rows, groups, N, K, K, m_tiles, n_tiles, groups * m_tiles * n_tiles};
}

// A's maps (above) over `K` elements of `esize` bytes a row, boxes of
// kStageK bytes x kBM rows; *tap receives the K elements of each map.
inline cudaError_t a_maps(AMaps* maps, int* tap, CUtensorMapDataType type, int esize,
                          const void* a, int lda, int a_rows, long long a_gstride, int groups,
                          int K) {
  const int box_k = kStageK / esize;
  *tap = lda >= K ? K : std::gcd(lda, K);
  if (K / *tap > kMaxTaps || (*tap != K && *tap % box_k)) return cudaErrorInvalidValue;
  // a single group's stride is its extent
  const cuuint64_t dims[3] = {static_cast<cuuint64_t>(*tap), static_cast<cuuint64_t>(a_rows),
                              static_cast<cuuint64_t>(groups)};
  const cuuint64_t strides[2] = {
      static_cast<cuuint64_t>(lda) * esize,
      static_cast<cuuint64_t>(groups > 1 ? a_gstride : static_cast<long long>(a_rows) * lda) *
          esize};
  const cuuint32_t box[3] = {static_cast<cuuint32_t>(box_k), kBM, 1};
  for (int j = 0; j < K / *tap; ++j) {
    const cudaError_t err =
        swizzled_map(&maps->tap[j], type, 3, static_cast<const char*>(a) + j * *tap * esize,
                     dims, strides, box);
    if (err != cudaSuccess) return err;
  }
  return cudaSuccess;
}

// W's map: [N rows, K], rows ldw elements apart, boxes of kStageK bytes x kBN rows.
inline cudaError_t w_map(CUtensorMap* map, CUtensorMapDataType type, int esize, const void* w,
                         int ldw, int N, int K) {
  const cuuint64_t dims[2] = {static_cast<cuuint64_t>(K), static_cast<cuuint64_t>(N)};
  const cuuint64_t strides[1] = {static_cast<cuuint64_t>(ldw) * esize};
  const cuuint32_t box[2] = {static_cast<cuuint32_t>(kStageK / esize), kBN};
  return swizzled_map(map, type, 2, w, dims, strides, box);
}

// Sets the kernel's dynamic shared memory and finds its persistent grid:
// one block per SM, or one per tile where there are fewer tiles.
template <typename Kernel>
inline cudaError_t prepare(Kernel kernel, const Shape& sh, int* grid) {
  cudaError_t err =
      cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, kSmemBytes);
  int sms = 0;
  if (err == cudaSuccess) err = sm_count(&sms);
  if (err != cudaSuccess) return err;
  *grid = sh.tiles < sms ? sh.tiles : sms;
  return cudaSuccess;
}

// Dynamic shared memory of a block and blocks resident per SM.
template <typename Kernel>
inline cudaError_t occupancy(Kernel kernel, int* smem_bytes, int* blocks_per_sm) {
  *smem_bytes = kSmemBytes;
  cudaError_t err =
      cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, kSmemBytes);
  if (err == cudaSuccess)
    err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(blocks_per_sm, kernel, kThreads,
                                                        kSmemBytes);
  return err;
}

}  // namespace gemm

// d += A B over 32 bytes of K: A [64 rows, 32 bytes] int8 in registers (the
// m64nNk32 A fragment: ldmatrix's four 8x8 b16 matrices of rows 0-7 / 8-15 x
// bytes 0-15 / 16-31), B [256 columns, 32 bytes] K-major in shared memory;
// exact int32 sums (posconv.cu's K16b).
__device__ __forceinline__ void wgmma_n256_rs(int (&d)[128], const uint32_t (&a)[4], uint64_t b) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %133, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n256k32.s32.s8.s8 " S3_ACC128
      ", {%128, %129, %130, %131}, %132, p;\n}\n"
      : S3_OUT128("+r", d)
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(b), "r"(1));
}

// ---- int8 products on 128-column tiles (int8_panel.cu, int8_conv.cu) ----

#define S3_ACC64                                                                           \
  "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "                \
  "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31, "       \
  "%32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47, "       \
  "%48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63}"
#define S3_OUT64(c, d)                                                                    \
  S3_D8(c, d, 0), S3_D8(c, d, 8), S3_D8(c, d, 16), S3_D8(c, d, 24), S3_D8(c, d, 32),     \
      S3_D8(c, d, 40), S3_D8(c, d, 48), S3_D8(c, d, 56)

// d (+)= A B over 32 bytes of K: A [64 rows, 32 bytes] and B [128 columns,
// 32 bytes], both K-major in shared memory, int8 in, exact int32 sums.
__device__ __forceinline__ void wgmma_n128(int (&d)[64], uint64_t a, uint64_t b, int accumulate) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %66, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k32.s32.s8.s8 " S3_ACC64 ", %64, %65, p;\n}\n"
      : S3_OUT64("+r", d)
      : "l"(a), "l"(b), "r"(accumulate));
}

}  // namespace s3
