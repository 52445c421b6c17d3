// Device helpers shared by the port's kernels (one shared library, plain C
// entry points bound with ctypes; see s3prl_tpu_torch/kernels/_build.py).
#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace s3 {

using bf16 = __nv_bfloat16;

constexpr float kLog2e = 1.4426950408889634f;

__device__ __forceinline__ float warp_sum(float v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
  return v;
}

// Exact GELU. The Pallas kernels use the A&S 7.1.26 polynomial for erf
// (max abs error 1.5e-7, s3prl_tpu/kernels/conv_frontend.py:32); erff is
// within that of it.
__device__ __forceinline__ float gelu_erf(float y) {
  return 0.5f * y * (1.0f + erff(y * 0.70710678118654752f));
}

// tanh-approximate GELU of the int8 serving path, in f32, as the Pallas
// kernels write it (s3prl_tpu/kernels/conv_frontend.py:55-57).
__device__ __forceinline__ float gelu_tanh(float y) {
  return 0.5f * y * (1.0f + tanhf(0.7978845608028654f * (y + 0.044715f * y * y * y)));
}

__device__ __forceinline__ float warp_max(float v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v = fmaxf(v, __shfl_xor_sync(0xffffffffu, v, o));
  return v;
}

// float -> int8 code: round half to even (rintf, as jnp.round; never
// roundf, which rounds half away from zero), clipped to [-127, 127].
__device__ __forceinline__ int8_t quant_code(float v) {
  return static_cast<int8_t>(fminf(fmaxf(rintf(v), -127.f), 127.f));
}

__device__ __forceinline__ float to_float(float v) { return v; }
__device__ __forceinline__ float to_float(bf16 v) { return __bfloat162float(v); }

// Stores 8 consecutive values; bf16 rounds to nearest even, as JAX's astype.
__device__ __forceinline__ void store8(float* p, const float* v) {
  reinterpret_cast<float4*>(p)[0] = make_float4(v[0], v[1], v[2], v[3]);
  reinterpret_cast<float4*>(p)[1] = make_float4(v[4], v[5], v[6], v[7]);
}
__device__ __forceinline__ void store8(bf16* p, const float* v) {
  __nv_bfloat162 h[4];
#pragma unroll
  for (int i = 0; i < 4; ++i) h[i] = __floats2bfloat162_rn(v[2 * i], v[2 * i + 1]);
  *reinterpret_cast<uint4*>(p) = *reinterpret_cast<const uint4*>(h);
}

// Loads 8 consecutive bf16 values (16 bytes, aligned) as floats.
__device__ __forceinline__ void load8(const bf16* p, float* v) {
  uint4 raw = *reinterpret_cast<const uint4*>(p);
  const __nv_bfloat162* h = reinterpret_cast<const __nv_bfloat162*>(&raw);
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    float2 f = __bfloat1622float2(h[i]);
    v[2 * i] = f.x;
    v[2 * i + 1] = f.y;
  }
}
__device__ __forceinline__ void load8(const float* p, float* v) {
  const float4 a = reinterpret_cast<const float4*>(p)[0], b = reinterpret_cast<const float4*>(p)[1];
  v[0] = a.x, v[1] = a.y, v[2] = a.z, v[3] = a.w, v[4] = b.x, v[5] = b.y, v[6] = b.z, v[7] = b.w;
}

// The row epilogue of the front-end kernels, on one 512-channel row held by
// one warp: lane l holds channels h * 256 + l * 8 + e (h < 2, e < 8) in
// v[h * 8 + e], so each half of the row is one 512-element coalesced run.
//
// ln_gelu_row512: LayerNorm in f32 (biased variance, eps 1e-5, 1 / sqrtf,
// the affine as __fmul_rn / __fadd_rn in the written order, as
// quant_rows.cu), then GELU (erf, or tanh with `tanh_mode`), in place.
// gamma and beta are 16-byte aligned (global or shared memory).
__device__ __forceinline__ void ln_gelu_row512(float* v, int lane, const float* gamma,
                                               const float* beta, bool tanh_mode) {
  float s = 0.f;
#pragma unroll
  for (int e = 0; e < 16; ++e) s += v[e];
  const float mean = warp_sum(s) / 512.f;
  float q = 0.f;
#pragma unroll
  for (int e = 0; e < 16; ++e) {
    const float d = v[e] - mean;
    q += d * d;
  }
  const float rstd = 1.f / sqrtf(warp_sum(q) / 512.f + 1e-5f);
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    float g[8], b[8];
    load8(gamma + h * 256 + lane * 8, g);
    load8(beta + h * 256 + lane * 8, b);
#pragma unroll
    for (int e = 0; e < 8; ++e) {
      const float z = __fadd_rn(__fmul_rn(__fmul_rn(v[h * 8 + e] - mean, rstd), g[e]), b[e]);
      v[h * 8 + e] = tanh_mode ? gelu_tanh(z) : gelu_erf(z);
    }
  }
}

// quant_row512: per-row int8 of such a row, s = max(absmax, 1e-8) / 127 and
// codes clip(rint(v / s)) (true division), written at the lane's two runs
// of 8 bytes of `qrow`; lane 0 writes s to *scale.
__device__ __forceinline__ void quant_row512(const float* v, int lane, int8_t* qrow,
                                             float* scale) {
  float amax = 0.f;
#pragma unroll
  for (int e = 0; e < 16; ++e) amax = fmaxf(amax, fabsf(v[e]));
  const float s = fmaxf(warp_max(amax), 1e-8f) / 127.f;
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    alignas(8) int8_t c[8];
#pragma unroll
    for (int e = 0; e < 8; ++e) c[e] = quant_code(v[h * 8 + e] / s);
    *reinterpret_cast<uint2*>(qrow + h * 256 + lane * 8) = *reinterpret_cast<const uint2*>(c);
  }
  if (lane == 0) *scale = s;
}

// Division by a row's scale (int8_conv.cu, conv0_ln_gelu.cu) without IEEE
// division's slow-path call (whose saves and restores spill beside the live
// sums): x / s rounded to f32 equals RN_f(x * r) for r a double within 2^-51
// of 1 / s. (For f32 x and s the exact quotient is either a float or more
// than 2^-49, relative, from every midpoint between two floats: with x = X
// 2^a, s = S 2^b and a midpoint m = M 2^c (X, S < 2^24, M < 2^25 odd), x - s
// m is a nonzero multiple of 2^min(a, b + c); so x * r, within 2^-50.6 of x
// / s, rounds to the same float.) r comes from the fast reciprocal (2^-22)
// and two Newton steps in double.
__device__ __forceinline__ double recip(float s) {
  const double sd = s;
  double r = __fdividef(1.f, s);
#pragma unroll
  for (int i = 0; i < 2; ++i) r = fma(r, fma(-sd, r, 1.0), r);
  return r;
}
__device__ __forceinline__ float div_by(float x, double r) {
  return static_cast<float>(static_cast<double>(x) * r);
}

// x / s rounded to nearest, given rf = RN(1 / s): IEEE division's fast path
// (the quotient by the reciprocal, then two residual corrections, each
// residual exact as an FMA), which is correctly rounded while x, s and x / s
// are normal; with the scales here (s >= 1e-8 / 127) a quotient outside
// that range is below 2^-90 and codes to 0 either way. Five f32 operations,
// where div_by's conversions to double would take the card's 16-a-clock
// conversion rate per element (conv0_ln_gelu.cu's K13a, posconv.cu's K16b).
__device__ __forceinline__ float div_rn(float x, float s, float rf) {
  float q = __fmul_rn(x, rf);
  q = __fmaf_rn(__fmaf_rn(-s, q, x), rf, q);
  return __fmaf_rn(__fmaf_rn(-s, q, x), rf, q);
}

// The int8 codes of four values already divided by the row scale, packed
// little-endian: rint by the float adder (v + 1.5 * 2^23 rounds half to
// even and leaves rint(v) in the low bits; its low byte is the code). |v|
// <= 127 + 2^-16 here (s = RN(max(absmax, 1e-8) / 127)), so the clip to [-127, 127]
// of clip(rint(v)) never binds.
__device__ __forceinline__ uint32_t pack_codes(float a, float b, float c, float d) {
  constexpr float kMagic = 12582912.f;  // 1.5 * 2^23
  const uint32_t lo = __byte_perm(__float_as_uint(__fadd_rn(a, kMagic)),
                                  __float_as_uint(__fadd_rn(b, kMagic)), 0x0040);
  const uint32_t hi = __byte_perm(__float_as_uint(__fadd_rn(c, kMagic)),
                                  __float_as_uint(__fadd_rn(d, kMagic)), 0x0040);
  return __byte_perm(lo, hi, 0x5410);
}

// 16-byte global -> shared copy that bypasses the registers; when `pred` is
// false nothing is read and the 16 shared bytes are zero-filled (the ragged
// edge of a tile).
__device__ __forceinline__ void cp_async16(void* smem, const void* gmem, bool pred) {
  unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(smem));
  int n = pred ? 16 : 0;
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(s), "l"(gmem), "r"(n)
               : "memory");
}
__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}
template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

}  // namespace s3
