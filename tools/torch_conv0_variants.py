#!/usr/bin/env python3
"""Builds variants of K3 / K13a's kernel (`s3prl_tpu_torch/csrc/conv0_ln_gelu.cu`)
alone and times them in turns on one GPU, with probes that show where the
kernel's time goes.

    python3 tools/torch_conv0_variants.py [--parent DIR] [--out FILE]

Each variant is the checkout's source with named text edits (VARIANTS),
built with the port's nvcc flags into its own library under
`build/conv0_variants/<name>/` and bound with ctypes. For each it prints
the registers and spills of every instantiation (ptxas -v) and the SASS
instructions of the bf16 instantiations' tile loop, holds K3 (erf, tanh)
and K13a at B=32 x 10 s against the plain versions (probes that change the
arithmetic are reported, not held), and times the three at B=32 x 10 s
with CUDA events, the variants in order and then in reverse, means of the
two. `--parent DIR` adds the source of another checkout (for example a
`git archive` of the parent commit) as the variant "parent". Then it
samples the SM clock and power (nvidia-smi) through 3,000 launches of the
kernel's K3 erf. Prints one JSON line {"device", "power_limit", "ms",
"build"} and appends it to `--out` when given.
"""

import argparse
import ctypes
import json
import os
import re
import shutil
import subprocess
import sys
import threading

import torch

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
SR = 16000

# K3 on bf16 waves with its conv recomputed in three passes (the mean, the
# squared deviations, the output) instead of the 128 sums held, at 16 warps a
# block; the fragment loads are volatile so that ptxas cannot fold the passes
THREE_PASSES = r'''
__device__ __forceinline__ uint4 load_fragment(const uint4* p) {
  uint4 v;
  asm volatile("ld.volatile.shared.v4.u32 {%0, %1, %2, %3}, [%4];\n"
               : "=r"(v.x), "=r"(v.y), "=r"(v.z), "=r"(v.w)
               : "r"(static_cast<uint32_t>(__cvta_generic_to_shared(p))));
  return v;
}

template <bool kTanh>
__device__ __forceinline__ void stream_tile(const uint4* wf, const uint32_t (&x)[2],
                                            const float* ln, bf16* out, size_t row0,
                                            int n_valid, int lane) {
  const int g = lane / 4, q = lane % 4;
  float mean[2], rstd[2], part[4] = {0.f, 0.f, 0.f, 0.f};
  const uint4* a = wf + lane;
#pragma unroll 4
  for (int mt = 0; mt < kMt; ++mt) {
    float d[4];
    mma_bf16(d, load_fragment(a + mt * 32), x);
#pragma unroll
    for (int c = 0; c < 4; ++c) part[c] += d[c];
  }
#pragma unroll
  for (int e = 0; e < 2; ++e) mean[e] = group_stat(part, e);
#pragma unroll
  for (int c = 0; c < 4; ++c) part[c] = 0.f;
#pragma unroll 4
  for (int mt = 0; mt < kMt; ++mt) {
    float d[4];
    mma_bf16(d, load_fragment(a + mt * 32), x);
#pragma unroll
    for (int c = 0; c < 4; ++c) {
      const float dev = d[c] - mean[c & 1];
      part[c] += dev * dev;
    }
  }
#pragma unroll
  for (int e = 0; e < 2; ++e) rstd[e] = inv_sqrt_rn(group_stat(part, e) + 1e-5f);
#pragma unroll 1
  for (int J = 0; J < kMt / 4; ++J) {
    const int ch0 = 64 * J + 8 * g;
    uint32_t w[2][4];
#pragma unroll
    for (int mp = 0; mp < 2; ++mp) {
      const float4 ga = *reinterpret_cast<const float4*>(ln + ch0 + 4 * mp);
      const float4 be = *reinterpret_cast<const float4*>(ln + kC + ch0 + 4 * mp);
      const float gv[4] = {ga.x, ga.y, ga.z, ga.w}, bv[4] = {be.x, be.y, be.z, be.w};
#pragma unroll
      for (int m2 = 0; m2 < 2; ++m2) {
        const int m = 2 * mp + m2;
        float d[4];
        mma_bf16(d, load_fragment(a + (4 * J + m) * 32), x);
#pragma unroll
        for (int e = 0; e < 2; ++e) {
          const float y0 = ln_gelu<kTanh>(d[e] - mean[e], rstd[e], gv[2 * m2], bv[2 * m2]);
          const float y1 =
              ln_gelu<kTanh>(d[2 + e] - mean[e], rstd[e], gv[2 * m2 + 1], bv[2 * m2 + 1]);
          const __nv_bfloat162 h2 = __floats2bfloat162_rn(y0, y1);
          w[e][m] = *reinterpret_cast<const uint32_t*>(&h2);
        }
      }
    }
#pragma unroll
    for (int e = 0; e < 2; ++e)
      if (2 * q + e < n_valid)
        *reinterpret_cast<uint4*>(out + (row0 + 2 * q + e) * kC + ch0) =
            make_uint4(w[e][0], w[e][1], w[e][2], w[e][3]);
  }
}

struct Args {'''

# name -> [(text of the committed source, its replacement)]
VARIANTS = {
    "kernel": [],
    "8 warps a block": [("constexpr int kWarpsMma = 12;", "constexpr int kWarpsMma = 8;")],
    "three passes, 16 warps (K3)": [
        ("\nstruct Args {", THREE_PASSES),
        ("    float acc[kMt][4];\n#pragma unroll\n    for (int mt = 0; mt < kMt; ++mt) mma_bf16(",
         "    if constexpr (sizeof(Out) == 2) {\n      uint32_t next[2] = {x[0], x[1]};\n"
         "      if (more) load_samples(next, wav, tile_at(tile + stride, a.tiles_per_utt),"
         " a.n_samples, lane);\n      stream_tile<kTanh>(wf, x, ln, static_cast<bf16*>(a.out),"
         " row0, a.n_frames - t.f0, lane);\n      x[0] = next[0], x[1] = next[1];\n"
         "      continue;\n    }\n    float acc[kMt][4];\n#pragma unroll\n"
         "    for (int mt = 0; mt < kMt; ++mt) mma_bf16("),
        ("{conv0_mma_kernel<bf16, false, kWarpsMma>, kWarpsMma}",
         "{conv0_mma_kernel<bf16, false, 16>, 16}"),
        ("{conv0_mma_kernel<bf16, true, kWarpsMma>, kWarpsMma}",
         "{conv0_mma_kernel<bf16, true, 16>, 16}")],
    "A&S erf": [
        ("template <bool kTanh>\n__device__ __forceinline__ float gelu(float z) {\n"
         "  return kTanh ? s3::gelu_tanh(z) : s3::gelu_erf(z);",
         "__device__ __forceinline__ float erf_as(float x) {\n"
         "  const float ax = fabsf(x);\n"
         "  const float t = __frcp_rn(__fmaf_rn(0.3275911f, ax, 1.f));\n"
         "  const float p = ((((1.061405429f * t - 1.453152027f) * t + 1.421413741f) * t"
         " - 0.284496736f) * t + 0.254829592f) * t;\n"
         "  return copysignf(1.f - p * expf(-ax * ax), x);\n}\n"
         "template <bool kTanh>\n__device__ __forceinline__ float gelu(float z) {\n"
         "  return kTanh ? s3::gelu_tanh(z) : 0.5f * z * (1.f + erf_as(z * 0.70710678f));")],
    # K13a's codes at div_by's cost (an f32 -> double -> f32 round trip and a
    # double product an element) and quant_code's rint and clip
    "probe: codes through double": [
        ("  float q = __fmul_rn(x, rf);\n  q = __fmaf_rn(__fmaf_rn(-s, q, x), rf, q);\n"
         "  return __fmaf_rn(__fmaf_rn(-s, q, x), rf, q);",
         "  return s3::div_by(x, static_cast<double>(rf));"),
        ("  constexpr float kMagic = 12582912.f;  // 1.5 * 2^23\n"
         "  const uint32_t lo = __byte_perm(__float_as_uint(__fadd_rn(a, kMagic)),\n"
         "                                  __float_as_uint(__fadd_rn(b, kMagic)), 0x0040);\n"
         "  const uint32_t hi = __byte_perm(__float_as_uint(__fadd_rn(c, kMagic)),\n"
         "                                  __float_as_uint(__fadd_rn(d, kMagic)), 0x0040);\n"
         "  return __byte_perm(lo, hi, 0x5410);",
         "  return static_cast<uint8_t>(s3::quant_code(a)) |\n"
         "         static_cast<uint32_t>(static_cast<uint8_t>(s3::quant_code(b))) << 8 |\n"
         "         static_cast<uint32_t>(static_cast<uint8_t>(s3::quant_code(c))) << 16 |\n"
         "         static_cast<uint32_t>(static_cast<uint8_t>(s3::quant_code(d))) << 24;")],
    # what is left without the GELU: the conv, the LN and the stores
    "probe: GELU as the identity": [
        ("  return kTanh ? s3::gelu_tanh(z) : s3::gelu_erf(z);", "  return z;")],
}
PROBES = ("probe: codes through double", "probe: GELU as the identity")


def build(name, src_dir, edits):
    """The variant's library (ctypes) and its build report, or None."""
    sys.path.insert(0, ROOT)
    from s3prl_tpu_torch.kernels import _build

    out = os.path.join(ROOT, "build", "conv0_variants", re.sub(r"\W+", "_", name))
    os.makedirs(out, exist_ok=True)
    for f in ("conv0_ln_gelu.cu", "common.cuh"):
        shutil.copy(os.path.join(src_dir, f), out)
    path = os.path.join(out, "conv0_ln_gelu.cu")
    text = open(path).read()
    for old, new in edits:
        if old not in text:
            raise SystemExit(f"{name}: the source has no {old[:60]!r}")
        text = text.replace(old, new)
    open(path, "w").write(text)
    lib = os.path.join(out, "lib.so")
    nvcc = _build._nvcc()
    proc = subprocess.run([nvcc, *_build.NVCC_FLAGS, "-shared", "-o", lib, path],
                          capture_output=True, text=True, timeout=600)
    if proc.returncode:
        print(f"[{name}] build failed:\n{(proc.stdout + proc.stderr)[-3000:]}", flush=True)
        return None
    report = {}
    lines = (proc.stdout + proc.stderr).splitlines()
    for i, line in enumerate(lines):
        m = re.search(r"Compiling entry function '(\w+)'", line)
        if m and "conv0" in m.group(1):
            info = " ".join(lines[i + 1:i + 5])
            regs = re.search(r"Used (\d+) registers", info)
            spills = sum(int(n) for n in re.findall(
                r"(\d+) bytes (?:stack frame|spill stores|spill loads)", info))
            report[m.group(1)] = {"registers": int(regs.group(1)) if regs else None,
                                  "stack_and_spills": spills}
    sass = subprocess.run([os.path.join(os.path.dirname(nvcc), "cuobjdump"), "-sass", lib],
                          capture_output=True, text=True, timeout=300).stdout
    from chip_smoke import tile_loop_instructions

    for part in sass.split("Function : ")[1:]:
        fname = part.split(None, 1)[0]
        if fname in report and "mma" in fname:
            report[fname]["tile_loop_instructions"] = tile_loop_instructions(part)
    for fname, r in sorted(report.items()):
        print(f"[{name}] {fname}: {r}", flush=True)
    handle = ctypes.CDLL(lib, mode=os.RTLD_LOCAL)
    P, I = ctypes.c_void_p, ctypes.c_int
    handle.s3_conv0_ln_gelu.argtypes = (P, P, P, P, P, I, I, I, I, I, P)
    handle.s3_conv0_ln_gelu_q8.argtypes = (P, P, P, P, P, P, I, I, I, I, P)
    return handle, report


def cuda_ms(fn, iters=20):
    fn()
    torch.cuda.synchronize()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / iters


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--parent", default=None)
    ap.add_argument("--out", default=None)
    args = ap.parse_args()
    if not torch.cuda.is_available():
        raise SystemExit("torch_conv0_variants: no CUDA device")
    sys.path.insert(0, ROOT)
    from s3prl_tpu_torch.kernels import conv_frontend as cf

    src = os.path.join(ROOT, "s3prl_tpu_torch", "csrc")
    built = {name: build(name, src, edits) for name, edits in VARIANTS.items()}
    if args.parent:
        built["parent"] = build("parent", os.path.join(args.parent, "s3prl_tpu_torch", "csrc"),
                                [])
    libs = {name: b[0] for name, b in built.items() if b}
    dev, gen = torch.device("cuda"), torch.Generator().manual_seed(0)
    B, n = 32, 10 * SR
    T = (n - 10) // 5 + 1
    wav = torch.randn(B, n, generator=gen).to(dev, torch.bfloat16)
    w = (torch.randn(512, 1, 10, generator=gen) * 10 ** -0.5).to(dev, torch.bfloat16)
    g = (1 + 0.1 * torch.randn(512, generator=gen)).to(dev)
    b = (0.1 * torch.randn(512, generator=gen)).to(dev)
    y = torch.empty(B, T, 512, dtype=torch.bfloat16, device=dev)
    q = torch.empty(B, T, 512, dtype=torch.int8, device=dev)
    s = torch.empty(B, T, 1, dtype=torch.float32, device=dev)
    stream = torch.cuda.current_stream().cuda_stream
    ptrs = (wav.data_ptr(), w.data_ptr(), g.data_ptr(), b.data_ptr())

    def call(lib, mode):
        if mode == "K13a":
            err = lib.s3_conv0_ln_gelu_q8(*ptrs, q.data_ptr(), s.data_ptr(), B, n, T, 1, stream)
        else:
            err = lib.s3_conv0_ln_gelu(*ptrs, y.data_ptr(), B, n, T, 1, int(mode == "K3 tanh"),
                                       stream)
        if err:
            raise RuntimeError(f"launch failed: CUDA error {err}")

    modes = ("K3 erf", "K3 tanh", "K13a")
    for name, lib in libs.items():
        for mode in modes:
            call(lib, mode)
            torch.cuda.synchronize()
            if mode == "K13a":
                want_q, want_s = cf.conv0_ln_gelu_q8_reference(wav, w, g, b)
                diff = (q.int() - want_q.int()).abs()
                held = int(diff.max()) <= 1 and float((diff > 0).float().mean()) <= 1e-3 \
                    and torch.allclose(s, want_s, rtol=1e-5, atol=0)
                what = f"codes differ in {float((diff > 0).float().mean()):.2e} of places"
            else:
                want = cf.conv0_ln_gelu_reference(wav, w, g, b, gelu_mode=mode.split()[1])
                err = (y.float() - want.float()).abs()
                step = torch.exp2(torch.floor(torch.log2(want.float().abs().clamp_min(
                    2.0 ** -126))) - 7)
                held = bool((err <= step.clamp_min(3e-2)).all())
                what = f"max_abs_err {float(err.max()):.3e}"
            print(f"[check] {name} {mode}: {what}, "
                  f"{'held' if held else 'NOT held'}", flush=True)
            if not held and name not in PROBES:
                raise SystemExit(f"{name} {mode} disagrees with the plain version")
    times = {}
    for name in list(libs) + list(libs)[::-1]:
        for mode in modes:
            times.setdefault(f"{mode}, {name}", []).append(
                cuda_ms(lambda lib=libs[name], m=mode: call(lib, m)))
    ms = {k: sum(v) / len(v) for k, v in times.items()}
    for k, v in ms.items():
        print(f"[time] B={B} x 10 s {k}: {v:.4f} ms", flush=True)

    samples, stop = [], threading.Event()

    def sample():
        while not stop.is_set():
            samples.append(subprocess.run(
                ["nvidia-smi", "--query-gpu=clocks.sm,power.draw", "--format=csv,noheader"],
                capture_output=True, text=True, timeout=60).stdout.strip())
            stop.wait(0.25)

    sampler = threading.Thread(target=sample)
    sampler.start()
    for _ in range(3000):
        call(libs["kernel"], "K3 erf")
    torch.cuda.synchronize()
    stop.set()
    sampler.join()
    print(f"[clocks] 3,000 launches of K3 erf: {samples}", flush=True)
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, check=True, timeout=60).stdout.strip()
    line = json.dumps({"device": torch.cuda.get_device_name(0), "power_limit": smi, "ms": ms,
                       "build": {k: b[1] for k, b in built.items() if b},
                       "clocks": samples})
    print(line, flush=True)
    if args.out:
        with open(args.out, "a") as f:
            f.write(line + "\n")


if __name__ == "__main__":
    main()
