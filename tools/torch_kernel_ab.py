#!/usr/bin/env python3
"""Times the kernels of one checkout of the PyTorch + CUDA port on one GPU, so
that two commits can be compared on one card in one run.

    python3 tools/torch_kernel_ab.py [--root DIR] [--label NAME] [--out FILE]

`--root` is the checkout whose `s3prl_tpu_torch` is imported (its kernels
are built into its own `build/`); by default the one holding this script.
At the main paths' shapes, with inputs from seed 0, it times with CUDA
events (mean of 10 after a warm-up, twice, averaged):
- K4 `fused_attention_block_bf16` and K5 `fused_bf16_ffn`, pre-LN, at
  B=32 x 499 frames, HuBERT-Large's widths, and the int8 twins, K1
  `fused_attention_block` and K2 `fused_int8_ffn`;
- K12 `fused_int8_linear` there in its two main-path sets: with the LN
  into N = 3,072 (the QKV projection of ``full_fuse``/``qkv_fuse``) and
  with the residual into N = 1,024 (the out-proj of ``full_fuse``);
- K6 `fused_qkv_attention_outproj` at B=8 x 1,499 (its main path, 30 s),
  and its out-proj alone on the f32 context: one panel launch on f32 rows,
  or, in a checkout whose panel refuses f32 rows, quant_rows.cu +
  gemm_s8.cu;
- K11 `gated_bias_attention_outproj` at B=32 x 499, WavLM-Large's widths,
  with a contiguous f32 pos_bias and with the ``wavlm_fuse`` model's rows
  padded to a multiple of 4 floats (null where the checkout refuses it);
- K3 `conv0_ln_gelu` (erf and tanh) and K13a `conv0_ln_gelu_q8` on B=32 x 10
  s of bf16 waves;
- K14 `fused_conv_ln_gelu` and K13b `fused_int8_conv_ln_gelu` (codes out but
  in the last layer) over the six mid layers of B=32 x 10 s, and K13b on
  each layer alone; K15 `ln_gelu` (tanh, as ``fused_midln`` under int8)
  over the six mid layers' outputs;
- K16a `pos_conv_gelu` and K16b `pos_conv_gelu_q8` at B=32 x 499 frames,
  HuBERT-Large's pos-conv (k 128, 16 groups of 64), bf16 x, and K16b's
  quantizer `posconv_quant` alone;
- K1's and K12's launches one by one, as the checkout makes them: on the
  int8 panel kernel (panel QKV, the attention, panel out-proj; K12 one
  panel launch), or, in a checkout without `_common.int8_panel`, on
  quant_rows.cu + gemm_s8.cu (x-quant, QKV, the attention, context quant,
  out-proj; K12 x-quant + GEMM), each stage fed the earlier stages' outputs;
- with `--forwards`, ms per forward of HuBERT-Large (`hub.load`, seed 0) by
  chip_smoke.py's protocol (chains of 5 and 15, best of 3, marginal) at B=32
  x 10 s and B=8 x 30 s: int8's default path (K3 tanh), ``full_fuse`` at
  both, ``qkv_fuse`` at 30 s (inert at 10 s), ``int8_posconv`` at both (one
  K16b), ``int8_conv`` at 10 s (K13a + six K13b in the front end), and bf16
  at 10 s (K3 erf).
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


def forwards(hub, dev, gen):
    """ms per forward of HuBERT-Large int8 on its default path and the
    options, and of bf16 at 10 s, chip_smoke.py's chain protocol."""
    out = {}
    for label, B, secs, paths in (("10 s", 32, 10, ("int8", "int8 full_fuse",
                                                    "int8 int8_posconv", "int8 int8_conv",
                                                    "bf16")),
                                  ("30 s", 8, 30, ("int8", "int8 full_fuse", "int8 qkv_fuse",
                                                   "int8 int8_posconv"))):
        n = secs * SR
        wavs = torch.randn(B, n, generator=gen).to(dev)
        lens = torch.full((B,), n, dtype=torch.long, device=dev)
        for path in paths:
            option = {p: True for p in path.split()[1:]}
            up = hub.load("hubert_large_ll60k", dtype=torch.bfloat16, flash=True,
                          quantize=path.split()[0] == "int8", device=dev, seed=0, **option)
            best = {it: min(it * cuda_ms(lambda: up.apply_standardized(wavs, lens), it)
                            for _ in range(3)) for it in (5, 15)}
            out[f"forward HuBERT {path} B={B} x {label}"] = (best[15] - best[5]) / 10
            del up
        del wavs
    return out


def main():
    here = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    ap = argparse.ArgumentParser()
    ap.add_argument("--root", default=here)
    ap.add_argument("--label", default="")
    ap.add_argument("--out", default=None)
    ap.add_argument("--forwards", action="store_true")
    args = ap.parse_args()
    if not torch.cuda.is_available():
        raise SystemExit("torch_kernel_ab: no CUDA device")
    sys.path.insert(0, os.path.abspath(args.root))
    from s3prl_tpu_torch import hub
    from s3prl_tpu_torch.kernels import _common as kc
    from s3prl_tpu_torch.kernels import conv_frontend as cf
    from s3prl_tpu_torch.kernels import ffn as k5
    from s3prl_tpu_torch.kernels import flash_attention as fa
    from s3prl_tpu_torch.kernels import ln_gelu as k15
    from s3prl_tpu_torch.kernels import posconv as pc
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
        res = rnd(B, T, C)
        ms["K12 fused_int8_linear, LN, N=3072"] = twice(
            lambda: k5.fused_int8_linear(x, wq8, bq, ln=ln))
        ms["K12 fused_int8_linear, residual, N=1024"] = twice(
            lambda: k5.fused_int8_linear(x, wo8, bo, residual=res))
        x2, res2 = x.view(B * T, C), res.view(B * T, C)
        if hasattr(kc, "int8_panel"):
            qkv = kc.int8_panel(x2, *wq8, bq, ln=ln, mode=kc.GEMM_QKV)
            attn = fa._attention(qkv.view(B, T, 3 * C), kv, H)
            stages = {
                "K1 stage QKV (int8_panel)":
                    lambda: kc.int8_panel(x2, *wq8, bq, ln=ln, mode=kc.GEMM_QKV),
                "K1 stage attention": lambda: fa._attention(qkv.view(B, T, 3 * C), kv, H),
                "K1 stage out-proj (int8_panel)":
                    lambda: kc.int8_panel(attn, *wo8, bo, rule=kc.RULE_CTX, residual=x2),
                "K12 stage LN, N=3072 (int8_panel)": lambda: kc.int8_panel(x2, *wq8, bq, ln=ln),
                "K12 stage residual, N=1024 (int8_panel)":
                    lambda: kc.int8_panel(x2, *wo8, bo, residual=res2)}
        else:
            x8, xs = kc.quant_rows(x2, ln=ln)
            qkv = kc.gemm_s8(x8, wq8[0], mode=kc.GEMM_QKV, row_scale=xs, col_scale=wq8[1],
                             bias=bq)
            attn = fa._attention(qkv.view(B, T, 3 * C), kv, H)
            a8, a_s = kc.quant_rows_bf16(attn)
            x8p, xsp = kc.quant_rows(x2)
            stages = {
                "K1 stage x-quant (LN + quant_rows)": lambda: kc.quant_rows(x2, ln=ln),
                "K1 stage QKV (gemm_s8)": lambda: kc.gemm_s8(
                    x8, wq8[0], mode=kc.GEMM_QKV, row_scale=xs, col_scale=wq8[1], bias=bq),
                "K1 stage attention": lambda: fa._attention(qkv.view(B, T, 3 * C), kv, H),
                "K1 stage context quant (quant_rows_bf16)": lambda: kc.quant_rows_bf16(attn),
                "K1 stage out-proj (gemm_s8)": lambda: kc.gemm_s8(
                    a8, wo8[0], mode=kc.GEMM_LINEAR, row_scale=a_s, col_scale=wo8[1], bias=bo,
                    residual=x2),
                "K12 stage LN, N=3072: x-quant (LN + quant_rows)":
                    lambda: kc.quant_rows(x2, ln=ln),
                "K12 stage LN, N=3072: GEMM (gemm_s8)": lambda: kc.gemm_s8(
                    x8, wq8[0], mode=kc.GEMM_LINEAR, row_scale=xs, col_scale=wq8[1], bias=bq),
                "K12 stage residual, N=1024: x-quant (quant_rows)": lambda: kc.quant_rows(x2),
                "K12 stage residual, N=1024: GEMM (gemm_s8)": lambda: kc.gemm_s8(
                    x8p, wo8[0], mode=kc.GEMM_LINEAR, row_scale=xsp, col_scale=wo8[1],
                    bias=bo, residual=res2)}
        for name, fn in stages.items():
            ms[name] = twice(fn)
        del stages, qkv, attn
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
        Tl = 1499  # K6 at B=8 x 30 s, its main path
        qkv, xl = rnd(8, Tl, 3 * C), rnd(8, Tl, C, scale=0.5)
        kvl = torch.tensor([Tl, Tl, (Tl * 5) // 8, 1] * 2, dtype=torch.int32, device=dev)
        ms["K6 fused_qkv_attention_outproj, B=8 x 1499"] = twice(
            lambda: fa.fused_qkv_attention_outproj(qkv, xl, wo8, bo, kvl, H))
        ctx, xl2 = fa._attention(qkv, kvl, H, out_f32=True), xl.view(-1, C)
        try:
            kc.int8_panel(ctx, *wo8, bo, residual=xl2)
            ms["K6 stage out-proj (int8_panel, f32 rows)"] = twice(
                lambda: kc.int8_panel(ctx, *wo8, bo, residual=xl2))
        except TypeError:  # a checkout whose panel takes bf16 rows only
            def pair():
                a8, s_a = kc.quant_rows(ctx)
                return kc.gemm_s8(a8, wo8[0], mode=kc.GEMM_LINEAR, row_scale=s_a,
                                  col_scale=wo8[1], bias=bo, residual=xl2)

            ms["K6 stage out-proj (quant_rows + gemm_s8)"] = twice(pair)
        del qkv, xl, ctx, xl2

        conv0 = (rnd(B, 10 * SR), rnd(512, 1, 10, scale=10 ** -0.5),
                 1 + rnd(512, scale=0.1, dtype=torch.float32),
                 rnd(512, scale=0.1, dtype=torch.float32))
        for mode in ("erf", "tanh"):
            ms[f"K3 conv0_ln_gelu {mode}, B={B} x 10 s"] = twice(
                lambda m=mode: cf.conv0_ln_gelu(*conv0, gelu_mode=m))
        ms[f"K13a conv0_ln_gelu_q8, B={B} x 10 s"] = twice(lambda: cf.conv0_ln_gelu_q8(*conv0))
        del conv0
        w16 = rnd(C, C // 16, 128, scale=(128 * C // 16) ** -0.5, dtype=torch.float32)
        b16 = rnd(C, scale=0.1, dtype=torch.float32)
        wg16, w816 = pc.posconv_gemm_weight(w16.to(bf), 16), pc.quantize_posconv_weight(w16, 16)
        ms[f"K16a pos_conv_gelu, B={B} x {T}"] = twice(lambda: pc.pos_conv_gelu(x, wg16, b16))
        ms[f"K16b pos_conv_gelu_q8, B={B} x {T}"] = twice(
            lambda: pc.pos_conv_gelu_q8(x, w816, b16))
        ms[f"K16b quantizer posconv_quant alone, B={B} x {T}"] = twice(
            lambda: pc.posconv_quant(x, 16))
        del w16, wg16, w816
        mid, mid8, mid15 = [], [], []
        for i, (k, Tm) in enumerate(MID):
            w = rnd(512, 512, k, scale=(512 * k) ** -0.5, dtype=torch.float32)
            g, b = 1 + rnd(512, scale=0.1, dtype=torch.float32), rnd(512, scale=0.1,
                                                                     dtype=torch.float32)
            xm = rnd(B, Tm, 512)
            mid.append((xm, cf.conv_gemm_weight(w.to(bf)), g, b))
            mid8.append((*quantize_rows(xm), cf.quantize_conv_taps(w), g, b, i < len(MID) - 1))
            mid15.append((rnd(B, (Tm - k) // 2 + 1, 512, scale=2.0), g, b))
        ms["K14 fused_conv_ln_gelu, six layers"] = twice(
            lambda: [cf.fused_conv_ln_gelu(*m) for m in mid])
        ms["K13b fused_int8_conv_ln_gelu, six layers"] = twice(
            lambda: [cf.fused_int8_conv_ln_gelu(*m[:5], emit_q8=m[5]) for m in mid8])
        ms["K15 ln_gelu tanh, six layers"] = twice(
            lambda: [k15.ln_gelu(*m, "tanh") for m in mid15])
        for i, m in enumerate(mid8):
            ms[f"K13b layer {i + 1} [{B}, {MID[i][1]}, 512] k={MID[i][0]}"] = twice(
                lambda m=m: cf.fused_int8_conv_ln_gelu(*m[:5], emit_q8=m[5]))
    if args.forwards:
        ms.update(forwards(hub, dev, gen))
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
