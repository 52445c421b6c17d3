#!/usr/bin/env python3
"""On-card check of the PyTorch + CUDA port (s3prl_tpu_torch) on one GPU.

    python3 chip_smoke.py

Phases (any failed check raises, so the exit code is not 0 and no result
line is printed):
 1. require a CUDA device; print the card's name and power limit;
 2. build the CUDA kernels from csrc/ (into build/) and print the seconds;
 3. each kernel against its plain PyTorch version on the same CUDA tensors,
    at the main paths' shapes with unit-scale inputs: cosine > 0.9995 and
    every element within max(3e-2, one bf16 step at the plain value) of
    it (one step is 0.03125 where LayerNorm outputs reach |v| >= 4). K3 in
    both GELU modes, K1 pre-LN and postnorm, K2 in five flag sets at
    C=1024, F=4096 (two chunks) and postnorm at C=768, F=3072 (one chunk),
    K4, K5; the share of int8 codes where the kernels' quantizers and the
    plain ones differ is printed. The int8 GEMM alone equals torch._int_mm
    exactly, and the quantizer rounds constructed ties half to even;
 4. the main paths at full width (hub.load("hubert_large_ll60k", bf16,
    flash, quantize=True) - the int8 serving default - and quantize=False),
    one apply_standardized each on B=8 x 10 s of mixed lengths; checks the
    [25, 8, 500, 1024] shape, exact h_lens, finite values, and the launch
    counts of each run: conv0 / K1 / K2 = 1 / 24 / 24 with K4, K5 at 0 for
    int8, conv0 / K4 / K5 = 1 / 24 / 24 with K1, K2 at 0 for bf16;
 5. the same seed's models on the CPU (the kernel wrappers' plain versions)
    against the card on B=2 x 2 s: per-layer cosine > 0.999 over valid
    frames, for each path; and the JAX package's int8 quality gate at full
    depth (tests/test_quant.py:82-124) on the card: the int8 model against
    the f32 model (flash=False) of the same weights, per-layer cosine >
    0.999;
 6. timing (printed): extraction audio-s/s of both paths at B=32 x 10 s
    (two chain lengths, marginal rate, best of 3, CUDA events) and each
    kernel against its plain version at B=32 shapes.
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


def kernel_inputs(B, T, gen, dev, C=1024, F=4096, H=16):
    """Main-path-shaped inputs for the kernels (HuBERT-Large widths by
    default); the int8 weights are the (codes, scales) pairs of the same
    bf16 weights, as the load-time cache holds them."""
    from s3prl_tpu_torch.ops.quant import as_quantized_cols

    def rnd(*shape, scale=1.0, dtype=torch.float32):
        return (torch.randn(shape, generator=gen) * scale).to(dev, dtype)

    bf = torch.bfloat16
    inp = dict(
        wav=rnd(B, 10 * SR, dtype=bf), conv_w=rnd(512, 1, 10, scale=10 ** -0.5, dtype=bf),
        conv_g=1 + rnd(512, scale=0.1), conv_b=rnd(512, scale=0.1),
        x=rnd(B, T, C, scale=0.5, dtype=bf),
        wq=rnd(3 * C, C, scale=C ** -0.5, dtype=bf), bq=rnd(3 * C, scale=0.02),
        wo=rnd(C, C, scale=C ** -0.5, dtype=bf), bo=rnd(C, scale=0.02),
        ln=(1 + rnd(C, scale=0.1), rnd(C, scale=0.1)),
        kv=torch.tensor(([T, T, (T * 5) // 8, 1] * B)[:B], dtype=torch.int32, device=dev),
        w1=rnd(F, C, scale=C ** -0.5, dtype=bf), b1=rnd(F, scale=0.02),
        w2=rnd(C, F, scale=F ** -0.5, dtype=bf), b2=rnd(C, scale=0.02), H=H)
    for name in ("wq", "wo", "w1", "w2"):
        inp[name + "8"] = as_quantized_cols(inp[name])
    return inp


FFN_FLAGS = ((True, True, False), (False, False, False), (True, False, False),
             (False, True, False), (True, True, True))


def kernel_calls(inp, inp_base=None):
    """name -> [(variant, kernel call, plain call)] over the same inputs;
    each name's first variant is the one its main path runs. `inp_base`
    (HuBERT-Base widths) adds K2's one-chunk postnorm case."""
    from s3prl_tpu_torch.kernels import conv_frontend as k3
    from s3prl_tpu_torch.kernels import ffn as k5
    from s3prl_tpu_torch.kernels import flash_attention as k4

    i = inp
    conv = (i["wav"], i["conv_w"], i["conv_g"], i["conv_b"])
    attn = (i["x"], i["wq"], i["bq"], i["ln"], i["wo"], i["bo"], i["kv"], i["H"])
    attn8 = (i["x"], i["wq8"], i["bq"], i["ln"], i["wo8"], i["bo"], i["kv"], i["H"])
    ffn = (i["x"], i["w1"], i["b1"], i["w2"], i["b2"])
    ffn8 = (i["x"], i["w18"], i["b1"], i["w28"], i["b2"])
    calls = {
        "conv0_ln_gelu": [
            (mode, lambda m=mode: k3.conv0_ln_gelu(*conv, gelu_mode=m),
             lambda m=mode: k3.conv0_ln_gelu_reference(*conv, gelu_mode=m))
            for mode in ("tanh", "erf")],
        "fused_attention_block": [
            (name, lambda p=p: k4.fused_attention_block(*attn8, postnorm=p),
             lambda p=p: k4.fused_attention_block_reference(*attn8, postnorm=p))
            for name, p in (("pre-LN", False), ("postnorm", True))],
        "fused_int8_ffn": [],
        "fused_attention_block_bf16": [
            (name, lambda p=p: k4.fused_attention_block_bf16(*attn, postnorm=p),
             lambda p=p: k4.fused_attention_block_bf16_reference(*attn, postnorm=p))
            for name, p in (("pre-LN", False), ("postnorm", True))],
        "fused_bf16_ffn": [],
    }
    for ln, res, post in FFN_FLAGS:
        kw = dict(ln=i["ln"] if ln else None, residual=res, postnorm=post)
        name = f"ln={ln} residual={res} postnorm={post}"
        calls["fused_int8_ffn"].append((
            name + " F=4096", lambda kw=kw: k5.fused_int8_ffn(*ffn8, **kw),
            lambda kw=kw: k5.fused_int8_ffn_reference(*ffn8, **kw)))
        calls["fused_bf16_ffn"].append((
            name, lambda kw=kw: k5.fused_bf16_ffn(*ffn, **kw),
            lambda kw=kw: k5.fused_bf16_ffn_reference(*ffn, **kw)))
    if inp_base is not None:
        b = inp_base
        ffn8b = (b["x"], b["w18"], b["b1"], b["w28"], b["b2"])
        kw = dict(ln=b["ln"], residual=True, postnorm=True)
        calls["fused_int8_ffn"].append((
            "ln=True residual=True postnorm=True C=768 F=3072",
            lambda: k5.fused_int8_ffn(*ffn8b, **kw),
            lambda: k5.fused_int8_ffn_reference(*ffn8b, **kw)))
    return calls


def code_mismatch(inp):
    """Share of int8 codes where the kernels' quantizers and the plain
    versions' differ, on the main path's inputs: K1's LN prologue and its
    bf16 context quantization, K2's LN prologue and its per-chunk requant of
    the fc1 output (each pair fed the same tensor)."""
    from s3prl_tpu_torch.kernels import _common as kc
    from s3prl_tpu_torch.kernels import ffn as k5
    from s3prl_tpu_torch.kernels import flash_attention as k4
    from s3prl_tpu_torch.ops.quant import int_mm, quantize_rows

    def share(a, b):
        return float((a != b).float().mean())

    x2 = inp["x"].view(-1, inp["x"].shape[-1])
    x8, xs = kc.quant_rows(x2, ln=inp["ln"])
    out = {"K1/K2 LN prologue": share(x8, quantize_rows(kc.layer_norm_f32(x2, inp["ln"]))[0])}
    qkv = (inp["x"].float() @ inp["wq"].float().t()).to(torch.bfloat16)
    ctx = k4.attention_reference(qkv, inp["kv"], inp["H"]).view(x2.shape)
    out["K1 context (bf16)"] = share(kc.quant_rows_bf16(ctx)[0],
                                     k4.quantize_context_reference(ctx)[0])
    w1q, w1s = inp["w18"]
    h = kc.gemm_s8(x8, w1q, mode=kc.GEMM_LINEAR, row_scale=xs, col_scale=w1s,
                   bias=inp["b1"], gelu=True, out_f32=True)
    h_plain = kc.gelu_tanh(int_mm(x8, w1q).float() * xs[:, None] * w1s + inp["b1"])
    diffs = []
    for lo, hi in k5._ffn_chunk_bounds(w1q.shape[0]):
        q, _ = kc.quant_rows(h, lo=lo, hi=hi)
        diffs.append(share(q[:, lo:hi], quantize_rows(h_plain[:, lo:hi])[0]))
    out["K2 chunk requant"] = sum(diffs) / len(diffs)
    return out


KERNELS = {  # wrapper -> (its main CUDA source, the TPU kernel it replaces)
    "conv0_ln_gelu": ("s3prl_tpu_torch/csrc/conv0_ln_gelu.cu",
                      "s3prl_tpu/kernels/conv_frontend.py:148"),
    "fused_attention_block": ("s3prl_tpu_torch/csrc/gemm_s8.cu",
                              "s3prl_tpu/kernels/flash_attention.py:633"),
    "fused_int8_ffn": ("s3prl_tpu_torch/csrc/gemm_s8.cu", "s3prl_tpu/kernels/ffn.py:129"),
    "fused_attention_block_bf16": ("s3prl_tpu_torch/csrc/attention.cu",
                                   "s3prl_tpu/kernels/flash_attention.py:772"),
    "fused_bf16_ffn": ("s3prl_tpu_torch/csrc/gemm_bf16.cu", "s3prl_tpu/kernels/ffn.py:320"),
}
# the main path each wrapper's launch count is read from
MAIN_PATH = {"conv0_ln_gelu": "int8", "fused_attention_block": "int8",
             "fused_int8_ffn": "int8", "fused_attention_block_bf16": "bf16",
             "fused_bf16_ffn": "bf16"}


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
    from s3prl_tpu_torch.kernels import _common as kc
    from s3prl_tpu_torch.ops.quant import int_mm

    gen = torch.Generator().manual_seed(0)
    inp = kernel_inputs(4, 499, gen, dev)
    inp_base = kernel_inputs(4, 499, gen, dev, C=768, F=3072, H=12)
    max_err = {}
    for name, variants in kernel_calls(inp, inp_base).items():
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
    for what, share in code_mismatch(inp).items():
        log(f"[int8 codes] {what}: {share:.3e} of codes differ from the plain version's")
    x8 = kc.quant_rows(inp["x"].view(-1, 1024), ln=inp["ln"])[0]
    for w8, lo, hi in ((inp["wq8"][0], 0, 1024), (inp["w28"][0], 0, 2048),
                       (inp["w28"][0], 2048, 4096)):
        a8 = kc.quant_rows(torch.randn(x8.shape[0], 4096, generator=gen).to(dev))[0] \
            if hi > 1024 else x8
        got = kc.gemm_s8(a8[:, lo:hi], w8[:, lo:hi])
        check(torch.equal(got, int_mm(a8[:, lo:hi].contiguous(), w8[:, lo:hi].contiguous())),
              f"gemm_s8 [{a8.shape[0]}, {hi - lo}] x [{w8.shape[0]}, {hi - lo}] vs torch._int_mm")
    log("[kernel] gemm_s8 alone equals torch._int_mm exactly (QKV, fc2 chunks 1 and 2)")
    ties = torch.tensor([[127.0, 2.5, -2.5, 3.5, -3.5, 0.5, -0.5, 1.5] * 128], device=dev)
    q, s = kc.quant_rows(ties)
    check(float(s[0]) == 1.0 and torch.equal(q[0], torch.round(ties[0]).to(torch.int8)),
          f"quantizer ties: {q[0, :8].tolist()}")
    log(f"[kernel] quant_rows rounds ties half to even: {q[0, :8].tolist()}")

    # 4. the main paths at full width, int8 (the serving default) then bf16
    ups = {path: hub.load("hubert_large_ll60k", dtype=torch.bfloat16, flash=True,
                          quantize=path == "int8", device=dev, seed=0)
           for path in ("int8", "bf16")}
    lens = [160000, 120000, 40000, 800, 159999, 80000, 16001, 1]
    wavs, lens_t = batch(lens, 10 * SR, gen, dev)
    expected = {"int8": {"conv0_ln_gelu": 1, "fused_attention_block": 24, "fused_int8_ffn": 24,
                         "fused_attention_block_bf16": 0, "fused_bf16_ffn": 0},
                "bf16": {"conv0_ln_gelu": 1, "fused_attention_block": 0, "fused_int8_ffn": 0,
                         "fused_attention_block_bf16": 24, "fused_bf16_ffn": 24}}
    launches = {}
    for path, up in ups.items():
        for w in wrapper.values():
            w.launches = 0
        hs, h_lens = up.apply_standardized(wavs, lens_t)
        torch.cuda.synchronize()
        launches[path] = {name: w.launches for name, w in wrapper.items()}
        log(f"[slice {path}] hs {tuple(hs.shape)} {hs.dtype}, h_lens {h_lens.tolist()}, "
            f"launches {launches[path]}")
        check(tuple(hs.shape) == (25, 8, 500, 1024), f"hs shape {tuple(hs.shape)}")
        check(h_lens.tolist() == [(n - 1) // 320 + 1 for n in lens], f"h_lens {h_lens.tolist()}")
        check(bool(torch.isfinite(hs).all()), "non-finite hidden states")
        check(launches[path] == expected[path], f"{path} launch counts {launches[path]}")
        del hs

    # 5. the same seed's models on the CPU (plain versions) vs the card; the
    # CPU int8 model takes the kernel route, whose wrappers run their plain
    # versions there
    import s3prl_tpu_torch.models.transformer as port_transformer

    small, small_lens = batch([32000, 20000], 32000, gen, "cpu")
    available = port_transformer._fused_block_available
    for path, up in ups.items():
        up_cpu = hub.load("hubert_large_ll60k", dtype=torch.bfloat16, flash=True,
                          quantize=path == "int8", device="cpu", seed=0)
        port_transformer._fused_block_available = lambda x: True
        try:
            hs_cpu, hl_cpu = up_cpu.apply_standardized(small, small_lens)
        finally:
            port_transformer._fused_block_available = available
        hs_gpu, hl_gpu = up.apply_standardized(small.to(dev), small_lens.to(dev))
        check(hl_cpu.tolist() == hl_gpu.tolist(), "h_lens CPU vs card")
        coss = layer_cosines(hs_gpu.cpu(), hs_cpu, hl_cpu.tolist())
        log(f"[cpu-vs-card {path}] per-layer cosine min {min(coss):.6f}: "
            + " ".join(f"{c:.5f}" for c in coss))
        check(min(coss) > COS_LAYER, f"per-layer cosine CPU vs card ({path})")
        del up_cpu, hs_cpu, hs_gpu
    up_f32 = hub.load("hubert_large_ll60k", dtype=torch.float32, flash=False, device=dev, seed=0)
    q_wavs, q_lens = batch([8000, 6400], 8000, gen, dev)
    hs_f, hl = up_f32.apply_standardized(q_wavs, q_lens)
    hs_q, _ = ups["int8"].apply_standardized(q_wavs, q_lens)
    coss = layer_cosines(hs_q.float(), hs_f, hl.tolist())
    log(f"[int8-vs-f32] 24L per-layer cosine min {min(coss):.6f}: "
        + " ".join(f"{c:.5f}" for c in coss))
    check(min(coss) > COS_LAYER, "per-layer cosine int8 vs f32 on the card")
    del up_f32, hs_f, hs_q

    # 6. timing: both paths at B=32 x 10 s, then each kernel vs its plain version
    B, secs = 32, 10.0
    wavs, lens_t = batch([int(secs * SR)] * B, int(secs * SR), gen, dev)
    it_lo, it_hi = 5, 15
    for path, up in ups.items():
        torch.cuda.reset_peak_memory_stats()
        best = {it: min(it * cuda_ms(lambda: up.apply_standardized(wavs, lens_t), it)
                        for _ in range(3))
                for it in (it_lo, it_hi)}
        per_iter = (best[it_hi] - best[it_lo]) / (it_hi - it_lo)
        rate = B * secs / (per_iter / 1e3)
        log(f"[timing] slice {path} B={B} x {secs:.0f} s: {per_iter:.2f} ms/forward, "
            f"{rate:.1f} audio-s/s (chains {it_lo}: {best[it_lo]:.1f} ms, "
            f"{it_hi}: {best[it_hi]:.1f} ms), peak device memory "
            f"{torch.cuda.max_memory_allocated() / 2**30:.2f} GiB")
    del ups, up, wavs

    inp = kernel_inputs(B, 499, gen, dev)
    log("[timing] plain versions run stock PyTorch on the card: f32 cuBLAS GEMMs (TF32 "
        "off) for the bf16 blocks, torch._int_mm (cuBLASLt int8) plus f32 elementwise "
        "passes for the int8 blocks")
    entries = []
    for name, variants in kernel_calls(inp).items():
        for variant, kernel, plain in variants[:2] if name == "conv0_ln_gelu" else variants[:1]:
            t = [cuda_ms(f, 10) for f in (plain, kernel, kernel, plain)]
            ms, plain_ms = (t[1] + t[2]) / 2, (t[0] + t[3]) / 2
            log(f"[timing] {name} {variant} B={B}: kernel {ms:.3f} ms, plain {plain_ms:.3f} ms")
            if variant != variants[0][0]:
                continue
            source, replaces = KERNELS[name]
            entries.append({"name": name, "route": "cuda", "source": source,
                            "replaces": replaces,
                            "launches": launches[MAIN_PATH[name]][name],
                            "max_abs_err": max_err[name], "ms": ms, "plain_ms": plain_ms})
    log(json.dumps({"kernels": entries}))
    print(json.dumps({"ok": True, "device": {"platform": "gpu",
                                             "kind": torch.cuda.get_device_name(0),
                                             "count": torch.cuda.device_count()}}), flush=True)


if __name__ == "__main__":
    main()
