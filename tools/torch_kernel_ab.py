#!/usr/bin/env python3
"""Times the GEMM blocks and K11 of one checkout of the PyTorch + CUDA port
on one GPU, so that two commits can be compared on one card in one run.

    python3 tools/torch_kernel_ab.py [--root DIR] [--label NAME] [--out FILE]

`--root` is the checkout whose `s3prl_tpu_torch` is imported (its kernels
are built into its own `build/`); by default the one holding this script.
At the main paths' shapes, with inputs from seed 0, it times with CUDA
events (mean of 10 after a warm-up, twice, averaged):
- K4 `fused_attention_block_bf16` and K5 `fused_bf16_ffn`, pre-LN, at
  B=32 x 499 frames, HuBERT-Large's widths, and the int8 twins that share
  the GEMM skeleton, K1 `fused_attention_block` and K2 `fused_int8_ffn`;
- K11 `gated_bias_attention_outproj` at B=32 x 499, WavLM-Large's widths,
  with a contiguous f32 pos_bias and with the ``wavlm_fuse`` model's rows
  padded to a multiple of 4 floats (null where the checkout refuses it);
- K14 `fused_conv_ln_gelu` and K13b `fused_int8_conv_ln_gelu` (codes out but
  in the last layer) over the six mid layers of B=32 x 10 s.
Prints one JSON line {"label", "root", "device", "power_limit", "ms": {...}}
and appends it to `--out` when given. Run it for the parent and the change
in turns (parent, change, change, parent) to compare them on one card.
"""

import argparse
import json
import os
import subprocess
import sys

import torch

SR = 16000
# (k, T) of the six mid layers' inputs at 10 s, as chip_smoke.py's MID
MID = ((3, 31999), (3, 15999), (3, 7999), (3, 3999), (2, 1999), (2, 999))


def cuda_ms(fn, iters=10):
    fn()
    torch.cuda.synchronize()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / iters


def twice(fn):
    return (cuda_ms(fn) + cuda_ms(fn)) / 2


def main():
    here = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    ap = argparse.ArgumentParser()
    ap.add_argument("--root", default=here)
    ap.add_argument("--label", default="")
    ap.add_argument("--out", default=None)
    args = ap.parse_args()
    if not torch.cuda.is_available():
        raise SystemExit("torch_kernel_ab: no CUDA device")
    sys.path.insert(0, os.path.abspath(args.root))
    from s3prl_tpu_torch.kernels import conv_frontend as cf
    from s3prl_tpu_torch.kernels import ffn as k5
    from s3prl_tpu_torch.kernels import flash_attention as fa
    from s3prl_tpu_torch.models.wavlm import bucket_table
    from s3prl_tpu_torch.ops.quant import as_quantized_cols, quantize_rows

    torch.backends.cuda.matmul.allow_tf32 = False
    dev, bf = torch.device("cuda"), torch.bfloat16
    gen = torch.Generator().manual_seed(0)

    def rnd(*shape, scale=1.0, dtype=bf):
        return (torch.randn(shape, generator=gen) * scale).to(dev, dtype)

    ms = {}
    with torch.inference_mode():
        B, T, C, F, H = 32, 499, 1024, 4096, 16
        x = rnd(B, T, C, scale=0.5)
        ln = (1 + rnd(C, scale=0.1, dtype=torch.float32), rnd(C, scale=0.1, dtype=torch.float32))
        kv = torch.tensor(([T, T, (T * 5) // 8, 1] * B)[:B], dtype=torch.int32, device=dev)
        wq, bq = rnd(3 * C, C, scale=C ** -0.5), rnd(3 * C, scale=0.02, dtype=torch.float32)
        wo, bo = rnd(C, C, scale=C ** -0.5), rnd(C, scale=0.02, dtype=torch.float32)
        w1, b1 = rnd(F, C, scale=C ** -0.5), rnd(F, scale=0.02, dtype=torch.float32)
        w2, b2 = rnd(C, F, scale=F ** -0.5), rnd(C, scale=0.02, dtype=torch.float32)
        ms["K4 fused_attention_block_bf16"] = twice(
            lambda: fa.fused_attention_block_bf16(x, wq, bq, ln, wo, bo, kv, H))
        ms["K5 fused_bf16_ffn"] = twice(
            lambda: k5.fused_bf16_ffn(x, w1, b1, w2, b2, ln=ln, residual=True))
        wq8, wo8, w18, w28 = (as_quantized_cols(w.float()) for w in (wq, wo, w1, w2))
        ms["K1 fused_attention_block"] = twice(
            lambda: fa.fused_attention_block(x, wq8, bq, ln, wo8, bo, kv, H))
        ms["K2 fused_int8_ffn"] = twice(
            lambda: k5.fused_int8_ffn(x, w18, b1, w28, b2, ln=ln, residual=True))
        del wq, w1, w2, wq8, w18, w28

        qkv = rnd(B, T, 3 * C)
        table = rnd(320, H, scale=0.5, dtype=torch.float32)
        gate = (1 + 2 * torch.rand(B, H, T, generator=gen)).to(dev)
        forms = {"contiguous": table.t()[:, bucket_table(T, 320, 800, dev)].contiguous(),
                 "rows padded to 4": table.t()[:, bucket_table(T, 320, 800, dev,
                                                               cols=-(-T // 4) * 4)][:, :, :T]}
        for form, pos_bias in forms.items():
            name = f"K11 gated_bias_attention_outproj, f32 bias {form}"
            try:
                ms[name] = twice(lambda: fa.gated_bias_attention_outproj(
                    qkv, x, pos_bias, gate, wo8, bo, kv, H))
            except ValueError as err:  # an older checkout takes the contiguous bias only
                ms[name] = None
                print(f"{name}: refused ({err})", flush=True)
        del qkv, forms

        mid, mid8 = [], []
        for i, (k, Tm) in enumerate(MID):
            w = rnd(512, 512, k, scale=(512 * k) ** -0.5, dtype=torch.float32)
            g, b = 1 + rnd(512, scale=0.1, dtype=torch.float32), rnd(512, scale=0.1,
                                                                     dtype=torch.float32)
            xm = rnd(B, Tm, 512)
            mid.append((xm, cf.conv_gemm_weight(w.to(bf)), g, b))
            mid8.append((*quantize_rows(xm), cf.quantize_conv_taps(w), g, b, i < len(MID) - 1))
        ms["K14 fused_conv_ln_gelu, six layers"] = twice(
            lambda: [cf.fused_conv_ln_gelu(*m) for m in mid])
        ms["K13b fused_int8_conv_ln_gelu, six layers"] = twice(
            lambda: [cf.fused_int8_conv_ln_gelu(*m[:5], emit_q8=m[5]) for m in mid8])
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, check=True, timeout=60).stdout.strip()
    line = json.dumps({"label": args.label, "root": args.root,
                       "device": torch.cuda.get_device_name(0), "power_limit": smi, "ms": ms})
    print(line, flush=True)
    if args.out:
        with open(args.out, "a") as f:
            f.write(line + "\n")


if __name__ == "__main__":
    main()
