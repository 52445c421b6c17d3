#!/usr/bin/env python3
"""Probes that chose K16b's design (`s3prl_tpu_torch/csrc/posconv.cu`), on
one GPU:

    python3 tools/torch_posconv_probe.py [--root DIR] [--out FILE]

Builds `tools/posconv_probe.cu` with the port's nvcc flags into
`build/posconv_probe/` and

1. holds one tap of the transposed design (the tap's weight as the
   register A operand, 256 window rows from any start row as the shared B
   operand through an unswizzled descriptor) against an integer product on
   the CPU, at start rows 0-15 and 31 and two window heights; fails on any
   difference;
2. times the main loops of both designs alone (resident window and tap
   tiles, one block per SM, 2,048 taps) with CUDA events, in turns (A, B,
   B, A), and prints each as TOP/s of int8 products;
3. times the K16b quantizer (`posconv_quant`), K16b and K16a of the
   checkout at `--root DIR` (default: this one; for example a `git archive`
   of another commit) at HuBERT-Large's widths on B=32 x 499 frames, bf16 x
   (and the quantizer on f32 x), in turns; then K16b at k 32 to 512 and the
   least-squares line through those times (its intercept: what no tap
   pays).

Prints the card's name and power limit first and one JSON line last, which
`--out` also receives.
"""

import argparse
import ctypes
import json
import os
import subprocess
import sys

import torch

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def build():
    from s3prl_tpu_torch.kernels import _build

    out = os.path.join(ROOT, "build", "posconv_probe")
    os.makedirs(out, exist_ok=True)
    lib = os.path.join(out, "libposconv_probe.so")
    csrc = os.path.join(ROOT, "s3prl_tpu_torch", "csrc")  # this checkout's hopper.cuh
    cmd = [_build._nvcc(), *_build.NVCC_FLAGS, "-shared", "-I", csrc,
           os.path.join(ROOT, "tools", "posconv_probe.cu"), "-o", lib]
    proc = subprocess.run(cmd, capture_output=True, text=True, timeout=600)
    print(proc.stdout + proc.stderr)
    if proc.returncode:
        raise SystemExit(f"nvcc failed ({proc.returncode})")
    so = ctypes.CDLL(lib)
    P, I = ctypes.c_void_p, ctypes.c_int
    so.probe_one_tap_launch.argtypes = [P, P, I, I, P]
    so.probe_loop_launch.argtypes = [I, I, I, P, P]
    return so


def events_ms(fn, iters):
    fn()
    torch.cuda.synchronize()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / iters


def check(ok, what):
    if not ok:
        raise SystemExit(f"probe failed: {what}")


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--out")
    ap.add_argument("--root", default=ROOT,
                    help="checkout whose s3prl_tpu_torch step 3 times (default: this one)")
    args = ap.parse_args()
    sys.path.insert(0, os.path.abspath(args.root))
    if not torch.cuda.is_available():
        raise SystemExit("needs a CUDA device")
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, check=True, timeout=60).stdout.strip()
    print(smi)
    so = build()
    dev = torch.device("cuda")
    gen = torch.Generator().manual_seed(0)
    result = {"device": torch.cuda.get_device_name(0), "power_limit": smi.split(",")[-1].strip(),
              "root": os.path.abspath(args.root)}

    # 1. one tap of design B from any start row (desc_plain: lbo the stride
    # along K, sbo along N)
    bad_total = 0
    for rows in (289, 300):
        xw = torch.randint(-127, 128, (rows, 64), generator=gen, dtype=torch.int8)
        w = torch.randint(-127, 128, (64, 64), generator=gen, dtype=torch.int8)
        xd, wd = xw.to(dev), w.to(dev)
        for j in list(range(16)) + [31]:
            out = torch.zeros(64, 256, dtype=torch.int32, device=dev)
            err = so.probe_one_tap_launch(xd.data_ptr(), wd.data_ptr(), rows, j,
                                          out.data_ptr())
            check(err == 0, f"one-tap launch: CUDA error {err}")
            torch.cuda.synchronize()
            want = (w.long() @ xw[j:j + 256].long().t()).int()
            bad = int((out.cpu() != want).sum())
            bad_total += bad
            if bad:
                print(f"[probe] window rows {rows}, start row {j}: {bad} of {want.numel()} "
                      "sums differ")
    result["one_tap_bad"] = bad_total
    print(f"[probe] one tap of design B: {bad_total} sums differ from the integer product "
          "over start rows 0-15 and 31, window heights 289 and 300")
    check(bad_total == 0, "design B's descriptor")

    # 2. the two main loops alone
    sms = torch.cuda.get_device_properties(0).multi_processor_count
    taps = 2048
    sink = torch.zeros(sms * 256, dtype=torch.int32, device=dev)
    stream = torch.cuda.current_stream().cuda_stream
    frames = {0: 256, 1: 512}  # a block's output frames: A two warpgroups x 128, B x 256

    def loop(design):
        err = so.probe_loop_launch(design, sms, taps, sink.data_ptr(), stream)
        check(err == 0, f"loop launch: CUDA error {err}")

    times = {0: [], 1: []}
    for design in (0, 1, 1, 0):
        times[design].append(events_ms(lambda: loop(design), 5))
    loops = {}
    for design, name in ((0, "A"), (1, "B")):
        ms = sum(times[design]) / 2
        tops = 2 * 64 * 64 * frames[design] * taps * sms / (ms * 1e-3) / 1e12
        loops[name] = {"ms": ms, "tops": tops, "frames_per_block": frames[design]}
        print(f"[probe] design {name} main loop alone: {ms:.4f} ms for {sms} blocks x "
              f"{frames[design]} frames x {taps} taps = {tops:.0f} TOP/s int8 "
              f"(runs {times[design][0]:.4f}, {times[design][1]:.4f})")
    result["loops"] = loops

    # 3. the checkout's quantizer and kernels at B=32 x 499
    from chip_smoke import posconv_inputs
    from s3prl_tpu_torch.kernels import posconv as pc

    i = posconv_inputs(32, 499, gen, dev)
    x, G = i["x"], i["G"]
    calls = {"posconv_quant bf16": lambda: pc.posconv_quant(x, G),
             "posconv_quant f32": lambda xf=x.float(): pc.posconv_quant(xf, G),
             "pos_conv_gelu_q8": lambda: pc.pos_conv_gelu_q8(x, i["w8"], i["bias"], G),
             "pos_conv_gelu": lambda: pc.pos_conv_gelu(x, i["wg"], i["bias"], G)}
    t = {name: [] for name in calls}
    for name in list(calls) + list(calls)[::-1]:
        t[name].append(events_ms(calls[name], 20))
    result["checkout_ms"] = {name: sum(v) / 2 for name, v in t.items()}
    for name, v in t.items():
        print(f"[probe] {name} B=32 x 499: {sum(v) / 2:.4f} ms (runs {v[0]:.4f}, {v[1]:.4f})")
    # K16b's time against its taps: the intercept is what no tap pays (the
    # scale pass, the window build, the epilogue, the tail of the last wave)
    sweep = {}
    for k in (32, 64, 128, 256, 512):
        wk = (torch.randn(1024, 64, k, generator=gen) * (64 * k) ** -0.5).to(dev)
        w8 = pc.quantize_posconv_weight(wk, G)
        sweep[k] = (events_ms(lambda: pc.pos_conv_gelu_q8(x, w8, i["bias"], G), 20)
                    + events_ms(lambda: pc.pos_conv_gelu_q8(x, w8, i["bias"], G), 20)) / 2
    ks = list(sweep)
    mk, mt = sum(ks) / len(ks), sum(sweep.values()) / len(ks)
    slope = sum((k - mk) * (sweep[k] - mt) for k in ks) / sum((k - mk) ** 2 for k in ks)
    result["k_sweep_ms"] = sweep
    result["k_fit"] = {"ms_at_k0": mt - slope * mk, "ms_per_tap": slope}
    print("[probe] K16b B=32 x 499 by taps: " + ", ".join(f"k {k} {t:.4f} ms"
                                                          for k, t in sweep.items())
          + f"; least squares {mt - slope * mk:.4f} ms + {slope * 1e3:.3f} us a tap")
    line = json.dumps(result)
    print(line)
    if args.out:
        with open(args.out, "a") as f:
            f.write(line + "\n")


if __name__ == "__main__":
    main()
