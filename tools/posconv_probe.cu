// Probes for K16b's design (s3prl_tpu_torch/csrc/posconv.cu), built and run by
// tools/torch_posconv_probe.py on one GPU.
//
// The window of an int8 pos-conv block, frames x 64 channels, is stored
// chunk-major: each 16-byte chunk of channels is a column of rows, so the 8
// rows of a core matrix are 128 contiguous bytes from any start row.
//
//   - probe_one_tap: one tap of design B, the tap's [64 n, 64 c] weight as
//     the register A operand (ldmatrix) and 256 window rows from row j as the
//     shared B operand through an unswizzled descriptor (desc_plain), two
//     wgmma m64n256k32; writes the [64, 256] int32 sums.
//   - probe_loop_a / probe_loop_b: the main loops of the two designs alone,
//     on a resident window and 8 resident tap tiles, for `taps` taps; one
//     block per SM. A (K16a's form): two warpgroups of 128 frames, the frames
//     as register A operands (ldmatrix from window rows t + j), the tap's
//     weight tile as the shared B operand (128-byte swizzle), m64n64k32. B:
//     two warpgroups of 256 frames, the weight as register A, the window as
//     shared B, m64n256k32.
#include "hopper.cuh"

namespace {

using namespace s3;

constexpr int kRowsLoop = 512 + 127;  // a 512-frame block's window at k = 128

__host__ __device__ constexpr int pad_rows(int rows) { return rows + (12 - rows % 8) % 8; }

__device__ __forceinline__ void ldsm_x4(uint32_t (&a)[4], uint32_t addr) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0, %1, %2, %3}, [%4];\n"
               : "=r"(a[0]), "=r"(a[1]), "=r"(a[2]), "=r"(a[3])
               : "r"(addr));
}

__device__ __forceinline__ void wgmma_n64_rs(int (&d)[32], const uint32_t (&a)[4], uint64_t b) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %37, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k32.s32.s8.s8 " S3_ACC32
      ", {%32, %33, %34, %35}, %36, p;\n}\n"
      : "+r"(d[0]), "+r"(d[1]), "+r"(d[2]), "+r"(d[3]), "+r"(d[4]), "+r"(d[5]), "+r"(d[6]),
        "+r"(d[7]), "+r"(d[8]), "+r"(d[9]), "+r"(d[10]), "+r"(d[11]), "+r"(d[12]),
        "+r"(d[13]), "+r"(d[14]), "+r"(d[15]), "+r"(d[16]), "+r"(d[17]), "+r"(d[18]),
        "+r"(d[19]), "+r"(d[20]), "+r"(d[21]), "+r"(d[22]), "+r"(d[23]), "+r"(d[24]),
        "+r"(d[25]), "+r"(d[26]), "+r"(d[27]), "+r"(d[28]), "+r"(d[29]), "+r"(d[30]),
        "+r"(d[31])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(b), "r"(1));
}

// lane l's ldmatrix row (of 16) and 16-byte chunk (of 2) in an m64nNk32 A
// fragment: matrices rows 0-7 / 8-15 x bytes 0-15 / 16-31
__device__ __forceinline__ int frag_row(int lane) { return (lane & 7) + ((lane >> 3) & 1) * 8; }

__global__ void __launch_bounds__(128) probe_one_tap(const int8_t* xw, const int8_t* w, int rows,
                                                     int j, int* out) {
  extern __shared__ __align__(1024) unsigned char smem[];
  const int cs = pad_rows(rows) * 16, tid = threadIdx.x;
  unsigned char* win = smem;
  unsigned char* wt = smem + ((4 * cs + 127) & ~127);
  for (int i = tid; i < rows * 4; i += 128)
    *reinterpret_cast<uint4*>(win + (i % 4) * cs + (i / 4) * 16) =
        *reinterpret_cast<const uint4*>(xw + (i / 4) * 64 + (i % 4) * 16);
  for (int i = tid; i < 64 * 4; i += 128)
    *reinterpret_cast<uint4*>(wt + i * 16) = *reinterpret_cast<const uint4*>(w + i * 16);
  fence_async_shared();
  __syncthreads();
  const int warp = tid / 32, lane = tid % 32;
  uint32_t a[2][4];
#pragma unroll
  for (int kk = 0; kk < 2; ++kk)
    ldsm_x4(a[kk], smem_u32(wt) + (16 * warp + frag_row(lane)) * 64 + 32 * kk + 16 * (lane >> 4));
  int acc[128];
#pragma unroll
  for (int i = 0; i < 128; ++i) acc[i] = 0;
  wg_fence();
#pragma unroll
  for (int kk = 0; kk < 2; ++kk)
    wgmma_n256_rs(acc, a[kk], desc_plain(smem_u32(win) + 2 * kk * cs + j * 16, cs, 128));
  wg_commit();
  wg_wait_all();
  fence_regs(acc);
  const int gid = lane / 4, tig = lane % 4;
#pragma unroll
  for (int i = 0; i < 32; ++i)
#pragma unroll
    for (int r = 0; r < 4; ++r)
      out[(16 * warp + gid + 8 * (r >> 1)) * 256 + 8 * i + 2 * tig + (r & 1)] = acc[4 * i + r];
}

// Fills the window and 8 tap tiles (32 KB) with pseudo-random bytes.
__device__ void fill(unsigned char* p, int bytes) {
  for (int i = threadIdx.x; i < bytes / 4; i += blockDim.x) {
    uint32_t h = (i + 1) * 2654435761u ^ (blockIdx.x * 40503u);
    h ^= h >> 13;
    reinterpret_cast<uint32_t*>(p)[i] = h * 2246822519u;
  }
  fence_async_shared();
  __syncthreads();
}

__global__ void __launch_bounds__(256, 1) probe_loop_b(int taps, int* sink) {
  extern __shared__ __align__(1024) unsigned char smem[];
  constexpr int cs = pad_rows(kRowsLoop) * 16;
  const uint32_t wt = (smem_u32(smem) + 1023) & ~1023u;  // 8 taps: 4 boxes [64 n, 128 bytes]
  const uint32_t win = wt + 8 * 4096;
  fill(smem, 1024 + 8 * 4096 + 4 * cs);
  const int tid = threadIdx.x, wg = tid / 128, warp = (tid % 128) / 32, lane = tid % 32;
  const int row = 16 * warp + frag_row(lane), hi = lane >> 4;
  auto load = [&](uint32_t (&a)[2][4], int j) {
    const uint32_t box = wt + ((j & 7) >> 1) * 8192;
#pragma unroll
    for (int kk = 0; kk < 2; ++kk) {
      const int chunk = 4 * (j & 1) + 2 * kk + hi;
      ldsm_x4(a[kk], box + row * 128 + ((chunk ^ (row & 7)) << 4));
    }
  };
  auto mma = [&](int (&acc)[128], const uint32_t (&a)[2][4], int j) {
    const uint32_t b0 = win + (wg * 256 + (j & 127)) * 16;
#pragma unroll
    for (int kk = 0; kk < 2; ++kk) wgmma_n256_rs(acc, a[kk], desc_plain(b0 + 2 * kk * cs, cs, 128));
  };
  int acc[128];
#pragma unroll
  for (int i = 0; i < 128; ++i) acc[i] = 0;
  uint32_t a0[2][4], a1[2][4];
  load(a0, 0);
  for (int j = 0; j < taps; j += 2) {
    wg_fence();
    mma(acc, a0, j);
    wg_commit();
    wg_wait_one();
    load(a1, j + 1);
    wg_fence();
    mma(acc, a1, j + 1);
    wg_commit();
    wg_wait_one();
    load(a0, j + 2);
  }
  wg_wait_all();
  fence_regs(acc);
  int s = 0;
#pragma unroll
  for (int i = 0; i < 128; ++i) s ^= acc[i];
  sink[blockIdx.x * 256 + tid] = s;
}

__global__ void __launch_bounds__(256, 1) probe_loop_a(int taps, int* sink) {
  extern __shared__ __align__(1024) unsigned char smem[];
  constexpr int cs = pad_rows(kRowsLoop) * 16;
  const uint32_t wt = (smem_u32(smem) + 1023) & ~1023u;
  const uint32_t win = wt + 8 * 4096;
  fill(smem, 1024 + 8 * 4096 + 4 * cs);
  const int tid = threadIdx.x, wg = tid / 128, warp = (tid % 128) / 32, lane = tid % 32;
  const int row0 = wg * 128 + 16 * warp + frag_row(lane), hi = lane >> 4;
  auto load = [&](uint32_t (&a)[2][2][4], int j) {  // [subtile][k step]
#pragma unroll
    for (int s = 0; s < 2; ++s)
#pragma unroll
      for (int kk = 0; kk < 2; ++kk)
        ldsm_x4(a[s][kk], win + (2 * kk + hi) * cs + (row0 + 64 * s + (j & 127)) * 16);
  };
  auto mma = [&](int (&acc)[2][32], const uint32_t (&a)[2][2][4], int j) {
    const uint32_t box = wt + ((j & 7) >> 1) * 8192 + 64 * (j & 1);
#pragma unroll
    for (int kk = 0; kk < 2; ++kk) {
      const uint64_t d = desc128(box + 32 * kk);
#pragma unroll
      for (int s = 0; s < 2; ++s) wgmma_n64_rs(acc[s], a[s][kk], d);
    }
  };
  int acc[2][32];
#pragma unroll
  for (int s = 0; s < 2; ++s)
#pragma unroll
    for (int i = 0; i < 32; ++i) acc[s][i] = 0;
  uint32_t a0[2][2][4], a1[2][2][4];
  load(a0, 0);
  for (int j = 0; j < taps; j += 2) {
    wg_fence();
    mma(acc, a0, j);
    wg_commit();
    wg_wait_one();
    load(a1, j + 1);
    wg_fence();
    mma(acc, a1, j + 1);
    wg_commit();
    wg_wait_one();
    load(a0, j + 2);
  }
  wg_wait_all();
  fence_regs(acc[0]);
  fence_regs(acc[1]);
  int s = 0;
#pragma unroll
  for (int i = 0; i < 32; ++i) s ^= acc[0][i] ^ acc[1][i];
  sink[blockIdx.x * 256 + tid] = s;
}

constexpr int kLoopSmem = 1024 + 8 * 4096 + 4 * pad_rows(kRowsLoop) * 16;

}  // namespace

extern "C" int probe_one_tap_launch(const void* xw, const void* w, int rows, int j, void* out) {
  const int smem = ((4 * pad_rows(rows) * 16 + 127) & ~127) + 4096;
  cudaError_t err =
      cudaFuncSetAttribute(probe_one_tap, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return static_cast<int>(err);
  probe_one_tap<<<1, 128, smem>>>(static_cast<const int8_t*>(xw), static_cast<const int8_t*>(w),
                                  rows, j, static_cast<int*>(out));
  return static_cast<int>(cudaGetLastError());
}

// design 0: A, 1: B; blocks of 256 threads, one per SM (the dynamic shared
// memory is raised to keep a second block off the SM)
extern "C" int probe_loop_launch(int design, int blocks, int taps, void* sink, void* stream) {
  const int smem = 120 * 1024;
  static_assert(kLoopSmem <= smem, "window and tiles");
  auto kernel = design ? probe_loop_b : probe_loop_a;
  cudaError_t err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return static_cast<int>(err);
  kernel<<<blocks, 256, smem, static_cast<cudaStream_t>(stream)>>>(taps, static_cast<int*>(sink));
  return static_cast<int>(cudaGetLastError());
}
