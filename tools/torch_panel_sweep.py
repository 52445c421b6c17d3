#!/usr/bin/env python3
"""Times the int8 panel projection (csrc/int8_panel.cu) alone across N, so
that its time splits into a fixed part (launch, prologue, the last tile's
epilogue) and a part per 128-column tile.

    python3 tools/torch_panel_sweep.py [--out FILE]

At M = 32 x 499 rows (B=32 x 10 s), C = 1,024, inputs from seed 0, for N in
128, 256, 512, 1,024, 2,048 and 3,072 it times with CUDA events (mean of 20
after a warm-up) the kernel in K1's and K12's sets: the f32 rule with the
LN (K12's QKV), without it, with it into the triple-rounded QKV epilogue
(K1's QKV), with a residual (K12's out-proj), and K1's bf16 context rule
with a residual (K1's out-proj); and beside them the wide-row route's pair
(quant_rows.cu + gemm_s8.cu, LN, no residual) at the same shape. Prints one
line a shape and, with `--out`, writes them as one JSON object with the
card's name and power limit.
"""

import argparse
import json
import os
import subprocess
import sys

import torch


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
    ap.add_argument("--out", default=None)
    args = ap.parse_args()
    if not torch.cuda.is_available():
        raise SystemExit("torch_panel_sweep: no CUDA device")
    sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
    from s3prl_tpu_torch.kernels import _common as kc
    from s3prl_tpu_torch.ops.quant import as_quantized_cols

    dev, bf = torch.device("cuda"), torch.bfloat16
    gen = torch.Generator().manual_seed(0)

    def rnd(*shape, scale=1.0, dtype=torch.float32):
        return (torch.randn(shape, generator=gen) * scale).to(dev, dtype)

    M, C = 32 * 499, 1024
    x = rnd(M, C, scale=0.5, dtype=bf)
    ln = (1 + rnd(C, scale=0.1), rnd(C, scale=0.1))
    rows = {}
    for N in (128, 256, 512, 1024, 2048, 3072):
        w8, ws = as_quantized_cols(rnd(N, C, scale=C ** -0.5))
        b, res = rnd(N, scale=0.02), rnd(M, N, scale=0.5, dtype=bf)

        def pair():
            x8, xs = kc.quant_rows(x, ln=ln)
            return kc.gemm_s8(x8, w8, mode=kc.GEMM_LINEAR, row_scale=xs, col_scale=ws, bias=b)

        calls = {
            "f32 rule, LN": lambda: kc.int8_panel(x, w8, ws, b, ln=ln),
            "f32 rule": lambda: kc.int8_panel(x, w8, ws, b),
            "f32 rule, LN, QKV epilogue": lambda: kc.int8_panel(x, w8, ws, b, ln=ln,
                                                                mode=kc.GEMM_QKV),
            "f32 rule, residual": lambda: kc.int8_panel(x, w8, ws, b, residual=res),
            "ctx rule, residual": lambda: kc.int8_panel(x, w8, ws, b, rule=kc.RULE_CTX,
                                                        residual=res),
            "pair (quant_rows + gemm_s8), LN": pair,
        }
        rows[N] = {name: cuda_ms(fn) for name, fn in calls.items()}
        print(f"[panel sweep] M={M} C={C} N={N}: "
              + ", ".join(f"{name} {ms:.4f} ms" for name, ms in rows[N].items()), flush=True)
        del w8, ws, b, res
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, check=True, timeout=60).stdout.strip()
    print(smi, flush=True)
    if args.out:
        with open(args.out, "w") as f:
            json.dump({"device": torch.cuda.get_device_name(0), "power_limit": smi, "M": M,
                       "C": C, "ms": rows}, f, indent=1)


if __name__ == "__main__":
    main()
