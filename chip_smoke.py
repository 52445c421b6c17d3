#!/usr/bin/env python3
"""On-card check of the PyTorch + CUDA port (s3prl_tpu_torch) on one GPU.

    python3 chip_smoke.py

Phases (any failed check raises, so the exit code is not 0 and no result
line is printed):
 1. require a CUDA device; print the card's name and power limit;
 2. build the CUDA kernels from csrc/ (into build/) and print the seconds;
 3. each kernel against its plain PyTorch version on the same CUDA tensors,
    at the main path's shapes with unit-scale inputs: cosine > 0.9995 and
    every element within max(3e-2, one bf16 step at the plain value) of
    it (one step is 0.03125 where LayerNorm outputs reach |v| >= 4);
 4. the main path: hub.load("hubert_large_ll60k", bf16, flash) at full
    width, one apply_standardized on B=8 x 10 s of mixed lengths; checks the
    [25, 8, 500, 1024] shape, exact h_lens, finite values, and that the
    kernel launch counts moved by exactly 1 / 24 / 24;
 5. the same seed's model on the CPU (plain versions) against the card on
    B=2 x 2 s: per-layer cosine > 0.999 over valid frames;
 6. timing (printed): extraction audio-s/s at B=32 x 10 s (two chain
    lengths, marginal rate, best of 3, CUDA events) and each kernel against
    its plain version at B=32 shapes.
The line before the last is a JSON object of the kernels; the last line is
{"ok": true, "device": {...}}.
"""

import json
import os
import subprocess
import sys
import time

import torch

SR = 16000
MAX_ABS_ERR = 3e-2
COS_KERNEL = 0.9995
COS_LAYER = 0.999


def log(msg):
    print(msg, flush=True)


def check(cond, msg):
    if not cond:
        raise RuntimeError(f"check failed: {msg}")


def compare(got, want):
    """(cosine, max abs error) of two tensors, in f64 on the card."""
    a, b = got.double().flatten(), want.double().flatten()
    cos = float(a @ b / (a.norm() * b.norm()))
    return cos, float((a - b).abs().max())


def within_tolerance(got, want):
    """Largest error over its elementwise bound max(3e-2, one bf16 step at
    the plain value). Two bf16 results whose f32 sums differ in order can
    round one step apart; at |v| >= 4 (LayerNorm outputs' tails) one step
    is 0.03125, beyond the 3e-2 that holds below it."""
    w = want.double()
    step = torch.exp2(torch.floor(torch.log2(w.abs().clamp_min(2.0 ** -126))) - 7)
    return float(((got.double() - w).abs() / step.clamp_min(MAX_ABS_ERR)).max())


def cuda_ms(fn, iters):
    """Mean device time of fn() over `iters` back-to-back calls (CUDA events)."""
    fn()
    torch.cuda.synchronize()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / iters


def kernel_inputs(B, T, gen, dev):
    """Main-path-shaped inputs for the three kernels (HuBERT-Large widths)."""
    C, F, H = 1024, 4096, 16

    def rnd(*shape, scale=1.0, dtype=torch.float32):
        return (torch.randn(shape, generator=gen) * scale).to(dev, dtype)

    bf = torch.bfloat16
    return dict(
        wav=rnd(B, 10 * SR, dtype=bf), conv_w=rnd(512, 1, 10, scale=10 ** -0.5, dtype=bf),
        conv_g=1 + rnd(512, scale=0.1), conv_b=rnd(512, scale=0.1),
        x=rnd(B, T, C, scale=0.5, dtype=bf),
        wq=rnd(3 * C, C, scale=C ** -0.5, dtype=bf), bq=rnd(3 * C, scale=0.02),
        wo=rnd(C, C, scale=C ** -0.5, dtype=bf), bo=rnd(C, scale=0.02),
        ln=(1 + rnd(C, scale=0.1), rnd(C, scale=0.1)),
        kv=torch.tensor(([T, T, (T * 5) // 8, 1] * B)[:B], dtype=torch.int32, device=dev),
        w1=rnd(F, C, scale=C ** -0.5, dtype=bf), b1=rnd(F, scale=0.02),
        w2=rnd(C, F, scale=F ** -0.5, dtype=bf), b2=rnd(C, scale=0.02), H=H)


def kernel_calls(inp):
    """name -> [(variant, kernel call, plain call)] over the same inputs."""
    from s3prl_tpu_torch.kernels import conv_frontend as k3
    from s3prl_tpu_torch.kernels import ffn as k5
    from s3prl_tpu_torch.kernels import flash_attention as k4

    i = inp
    conv = (i["wav"], i["conv_w"], i["conv_g"], i["conv_b"])
    attn = (i["x"], i["wq"], i["bq"], i["ln"], i["wo"], i["bo"], i["kv"], i["H"])
    ffn = (i["x"], i["w1"], i["b1"], i["w2"], i["b2"])
    calls = {
        "conv0_ln_gelu": [("bf16", lambda: k3.conv0_ln_gelu(*conv),
                           lambda: k3.conv0_ln_gelu_reference(*conv))],
        "fused_attention_block_bf16": [
            (name, lambda p=p: k4.fused_attention_block_bf16(*attn, postnorm=p),
             lambda p=p: k4.fused_attention_block_bf16_reference(*attn, postnorm=p))
            for name, p in (("pre-LN", False), ("postnorm", True))],
        "fused_bf16_ffn": [],
    }
    for ln, res, post in ((True, True, False), (False, False, False), (True, False, False),
                          (False, True, False), (True, True, True)):
        kw = dict(ln=i["ln"] if ln else None, residual=res, postnorm=post)
        calls["fused_bf16_ffn"].append((
            f"ln={ln} residual={res} postnorm={post}",
            lambda kw=kw: k5.fused_bf16_ffn(*ffn, **kw),
            lambda kw=kw: k5.fused_bf16_ffn_reference(*ffn, **kw)))
    return calls


KERNELS = {  # wrapper -> (its main CUDA source, the TPU kernel it replaces)
    "conv0_ln_gelu": ("s3prl_tpu_torch/csrc/conv0_ln_gelu.cu",
                      "s3prl_tpu/kernels/conv_frontend.py:148"),
    "fused_attention_block_bf16": ("s3prl_tpu_torch/csrc/attention.cu",
                                   "s3prl_tpu/kernels/flash_attention.py:772"),
    "fused_bf16_ffn": ("s3prl_tpu_torch/csrc/gemm_bf16.cu", "s3prl_tpu/kernels/ffn.py:320"),
}


def batch(lens, T, gen, dev):
    wavs = torch.randn(len(lens), T, generator=gen)
    lens_t = torch.tensor(lens)
    wavs = wavs * (torch.arange(T)[None, :] < lens_t[:, None])
    return wavs.to(dev), lens_t.to(dev)


def layer_cosines(a, b, h_lens):
    """Per-layer cosine over the valid frames of every utterance."""
    out = []
    for layer in range(a.shape[0]):
        parts_a = [a[layer, i, :n] for i, n in enumerate(h_lens)]
        parts_b = [b[layer, i, :n] for i, n in enumerate(h_lens)]
        out.append(compare(torch.cat(parts_a), torch.cat(parts_b))[0])
    return out


def main():
    if not torch.cuda.is_available():
        raise SystemExit("chip_smoke: no CUDA device (torch.cuda.is_available() is False)")
    sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
    from s3prl_tpu_torch import hub
    from s3prl_tpu_torch.kernels import _build, wrappers

    torch.backends.cuda.matmul.allow_tf32 = False  # f32 references in full f32
    torch.backends.cudnn.allow_tf32 = False
    dev = torch.device("cuda")
    wrapper = {w.__name__: w for w in wrappers()}

    # 1. the card
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, check=True, timeout=60).stdout.strip()
    log(smi.splitlines()[0])
    log(f"torch {torch.__version__} cuda {torch.version.cuda} {torch.cuda.get_device_name(0)}")

    # 2. build
    t0 = time.perf_counter()
    lib = _build.library()
    log(f"[build] {lib._name} in {time.perf_counter() - t0:.1f} s")

    # 3. kernel vs plain at main-path shapes
    gen = torch.Generator().manual_seed(0)
    inp = kernel_inputs(4, 499, gen, dev)
    max_err = {}
    for name, variants in kernel_calls(inp).items():
        for variant, kernel, plain in variants:
            got, want = kernel(), plain()
            torch.cuda.synchronize()
            check(got.shape == want.shape and got.dtype == want.dtype,
                  f"{name} {variant}: {tuple(got.shape)} {got.dtype} "
                  f"vs {tuple(want.shape)} {want.dtype}")
            cos, err = compare(got, want)
            ratio = within_tolerance(got, want)
            log(f"[kernel] {name} {variant} {tuple(got.shape)}: cos {cos:.7f} "
                f"max_abs_err {err:.3e} (max err / bound {ratio:.3f})")
            check(cos > COS_KERNEL and ratio <= 1.0, f"{name} {variant} vs plain")
            max_err[name] = max(max_err.get(name, 0.0), err)

    # 4. the main path at full width
    up = hub.load("hubert_large_ll60k", dtype=torch.bfloat16, flash=True, device=dev, seed=0)
    lens = [160000, 120000, 40000, 800, 159999, 80000, 16001, 1]
    wavs, lens_t = batch(lens, 10 * SR, gen, dev)
    for w in wrapper.values():
        w.launches = 0
    hs, h_lens = up.apply_standardized(wavs, lens_t)
    torch.cuda.synchronize()
    launches = {name: w.launches for name, w in wrapper.items()}
    log(f"[slice] hs {tuple(hs.shape)} {hs.dtype}, h_lens {h_lens.tolist()}, launches {launches}")
    check(tuple(hs.shape) == (25, 8, 500, 1024), f"hs shape {tuple(hs.shape)}")
    check(h_lens.tolist() == [(n - 1) // 320 + 1 for n in lens], f"h_lens {h_lens.tolist()}")
    check(bool(torch.isfinite(hs).all()), "non-finite hidden states")
    check(launches == {"conv0_ln_gelu": 1, "fused_attention_block_bf16": 24,
                       "fused_bf16_ffn": 24}, f"launch counts {launches}")
    del hs

    # 5. the same seed's model on the CPU (plain versions) vs the card
    up_cpu = hub.load("hubert_large_ll60k", dtype=torch.bfloat16, flash=True, device="cpu",
                      seed=0)
    small, small_lens = batch([32000, 20000], 32000, gen, "cpu")
    hs_cpu, hl_cpu = up_cpu.apply_standardized(small, small_lens)
    hs_gpu, hl_gpu = up.apply_standardized(small.to(dev), small_lens.to(dev))
    check(hl_cpu.tolist() == hl_gpu.tolist(), "h_lens CPU vs card")
    coss = layer_cosines(hs_gpu.cpu(), hs_cpu, hl_cpu.tolist())
    log(f"[cpu-vs-card] per-layer cosine min {min(coss):.6f}: "
        + " ".join(f"{c:.5f}" for c in coss))
    check(min(coss) > COS_LAYER, "per-layer cosine CPU vs card")
    del up_cpu, hs_cpu, hs_gpu

    # 6. timing: the slice at B=32 x 10 s, then each kernel vs its plain version
    B, secs = 32, 10.0
    wavs, lens_t = batch([int(secs * SR)] * B, int(secs * SR), gen, dev)
    it_lo, it_hi = 5, 15
    best = {it: min(it * cuda_ms(lambda: up.apply_standardized(wavs, lens_t), it)
                    for _ in range(3))
            for it in (it_lo, it_hi)}
    per_iter = (best[it_hi] - best[it_lo]) / (it_hi - it_lo)
    rate = B * secs / (per_iter / 1e3)
    log(f"[timing] slice B={B} x {secs:.0f} s: {per_iter:.2f} ms/forward, "
        f"{rate:.1f} audio-s/s (chains {it_lo}: {best[it_lo]:.1f} ms, "
        f"{it_hi}: {best[it_hi]:.1f} ms)")
    log(f"[timing] peak device memory {torch.cuda.max_memory_allocated() / 2**30:.2f} GiB")
    del up, wavs

    inp = kernel_inputs(B, 499, gen, dev)
    entries = []
    for name, variants in kernel_calls(inp).items():
        _, kernel, plain = variants[0]  # the main path's variant
        t = [cuda_ms(f, 10) for f in (plain, kernel, kernel, plain)]
        ms, plain_ms = (t[1] + t[2]) / 2, (t[0] + t[3]) / 2
        log(f"[timing] {name} {variants[0][0]} B={B}: kernel {ms:.3f} ms, plain {plain_ms:.3f} ms")
        source, replaces = KERNELS[name]
        entries.append({"name": name, "route": "cuda", "source": source, "replaces": replaces,
                        "launches": launches[name], "max_abs_err": max_err[name],
                        "ms": ms, "plain_ms": plain_ms})
    log(json.dumps({"kernels": entries}))
    print(json.dumps({"ok": True, "device": {"platform": "gpu",
                                             "kind": torch.cuda.get_device_name(0),
                                             "count": torch.cuda.device_count()}}), flush=True)


if __name__ == "__main__":
    main()
