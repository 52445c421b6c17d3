#!/usr/bin/env python3
"""Where a WavLM-Large forward of the PyTorch + CUDA port spends its time,
on one GPU.

    python3 tools/torch_wavlm_breakdown.py [--out chiprun_out/wavlm_breakdown.json]

For int8 (the serving default) and bf16, at B=32 x 10 s, B=8 x 30 s and
B=4 x 60 s (full-length utterances, random weights from seed 0), it times
with CUDA events (mean of 5 after a warm-up): the whole forward
(`apply_standardized`), the front end (wave normalisation and the conv
extractor), the feature LN and projection, the pos-conv, the shared
pos_bias gather, and the parts of one encoder layer (layer 0 alone, times
24): the LN before the attention, the gate, the QKV projection, the head
split, K9/K10, the head merge, the out-projection with the residual, the
FFN block. A part of a few small launches (the gate) is bound by the
host's launch rate when it is timed alone; in a forward those launches
overlap the device's work. The device's idle share is 1 - (the
profiler's summed kernel time over 3 forwards) / (their event time).
Prints one line per part and writes the table as JSON. Imports torch and
the port only.
"""

import argparse
import json
import os
import subprocess
import sys

import torch

SR = 16000
BATCHES = (("10 s", 32, 10), ("30 s", 8, 30), ("60 s", 4, 60))


def cuda_ms(fn, iters=5):
    fn()
    torch.cuda.synchronize()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / iters


def idle_share(fn, iters=3):
    """1 - summed device kernel time / event time over `iters` calls."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        start.record()
        for _ in range(iters):
            fn()
        end.record()
        end.synchronize()
    wall_us = start.elapsed_time(end) * 1e3
    busy_us = sum(evt.self_device_time_total for evt in prof.key_averages()
                  if evt.device_type == DeviceType.CUDA)
    return 1.0 - busy_us / wall_us, busy_us / wall_us


@torch.inference_mode()
def breakdown(path, B, secs, dev):
    from s3prl_tpu_torch import hub
    from s3prl_tpu_torch.kernels import flash_attention as fa
    from s3prl_tpu_torch.kernels.ffn import fused_int8_ffn
    from s3prl_tpu_torch.models.transformer import _layer_norm, _linear
    from s3prl_tpu_torch.models.wav2vec2 import normalize_wavs
    from s3prl_tpu_torch.ops.quant import int8_matmul

    up = hub.load("wavlm_large", dtype=torch.bfloat16, flash=True, quantize=path == "int8",
                  device=dev, seed=0)
    model, enc = up.model, up.model.encoder
    n = int(secs * SR)
    wavs = torch.randn(B, n, generator=torch.Generator().manual_seed(1)).to(dev)
    lens = torch.full((B,), n, device=dev)
    parts = {"forward": cuda_ms(lambda: up.apply_standardized(wavs, lens))}
    parts["front end (normalize + extractor)"] = cuda_ms(
        lambda: model.feature_extractor(normalize_wavs(wavs, lens)))
    feats = model.feature_extractor(normalize_wavs(wavs, lens))
    T = feats.shape[1]

    def proj():
        f = torch.nn.functional.layer_norm(feats.float(), (feats.shape[-1],),
                                           model.layer_norm.weight, model.layer_norm.bias,
                                           eps=1e-5).to(model.dtype)
        return _linear(f, model.post_extract_proj)

    parts["feature LN + projection"] = cuda_ms(proj)
    x = proj()
    parts["pos-conv"] = cuda_ms(lambda: x + enc.pos_conv(x))
    parts["pos_bias gather (once per forward)"] = cuda_ms(lambda: enc._layer_args(T, x.device))
    (pos_bias,) = enc._layer_args(T, x.device)
    kv = torch.full((B,), T, dtype=torch.int32, device=dev)
    pad = torch.zeros(B, T, dtype=torch.bool, device=dev)
    layer = enc.layers[0]
    attn, ln1, ln2 = layer.self_attn, layer.self_attn_layer_norm, layer.final_layer_norm
    L = len(enc.layers)
    parts["24 encoder layers (layer 0 alone x 24)"] = L * cuda_ms(
        lambda: layer(x, kv, pad, pos_bias))
    h = _layer_norm(x, ln1)
    gate = attn.gate(h)

    def qkv_proj():
        if layer.quantize:
            return int8_matmul(h, attn.qpair("qkv"), attn.qkv_bias)
        return torch.nn.functional.linear(h, attn.qkv_weight, attn.qkv_bias.to(h.dtype))

    qkv = qkv_proj()
    q, k, v = fa._split_heads(qkv, attn.num_heads)
    out = fa.gated_bias_attention(q, k, v, pos_bias, gate.float(), kv)
    ctx = out.transpose(1, 2).reshape(B, T, -1)

    def out_proj():
        if layer.quantize:
            return x + int8_matmul(ctx, attn.qpair("out_proj"), attn.out_proj.bias)
        return x + _linear(ctx, attn.out_proj)

    def ffn():
        if layer.quantize:
            return fused_int8_ffn(x, layer.qpair("fc1"), layer.fc1.bias, layer.qpair("fc2"),
                                  layer.fc2.bias, ln=(ln2.weight, ln2.bias), residual=True)
        return x + layer._ffn(_layer_norm(x, ln2))

    for name, fn in (("- LN before the attention", lambda: _layer_norm(x, ln1)),
                     ("- gate (grep_linear, sigmoid, in the model dtype; f32 cast)",
                      lambda: attn.gate(h).float()),
                     ("- QKV projection", qkv_proj),
                     ("- heads split out of [B, T, 3C]", lambda: fa._split_heads(qkv, attn.num_heads)),
                     ("- attention: K9 (K10 beyond 2,048 frames)",
                      lambda: fa.gated_bias_attention(q, k, v, pos_bias, gate.float(), kv)),
                     ("- heads merged into [B, T, C]",
                      lambda: out.transpose(1, 2).reshape(B, T, -1)),
                     ("- out-projection + residual", out_proj),
                     ("- FFN block (K2 / LN + module path)", ffn)):
        parts[name] = L * cuda_ms(fn)
    parts["final LN + capture"] = cuda_ms(lambda: _layer_norm(x, enc.layer_norm))
    idle, busy = idle_share(lambda: up.apply_standardized(wavs, lens))
    parts["idle share"] = idle
    parts["profiler kernel time / event time"] = busy
    del up, model, enc
    torch.cuda.empty_cache()
    return T, parts


def main():
    parser = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    parser.add_argument("--out", default="chiprun_out/wavlm_breakdown.json")
    args = parser.parse_args()
    if not torch.cuda.is_available():
        raise SystemExit("torch_wavlm_breakdown: no CUDA device")
    sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, check=True, timeout=60).stdout.strip()
    print(smi.splitlines()[0], flush=True)
    table = {"card": smi.splitlines()[0], "columns": {}}
    for path in ("int8", "bf16"):
        for label, B, secs in BATCHES:
            T, parts = breakdown(path, B, secs, torch.device("cuda"))
            column = f"{path} B={B} x {label} (T'={T})"
            table["columns"][column] = parts
            for name, value in parts.items():
                print(f"[breakdown] {column} {name}: {value:.4f}", flush=True)
    os.makedirs(os.path.dirname(args.out) or ".", exist_ok=True)
    with open(args.out, "w") as f:
        json.dump(table, f, indent=1)


if __name__ == "__main__":
    main()
