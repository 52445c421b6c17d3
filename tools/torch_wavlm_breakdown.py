#!/usr/bin/env python3
"""Where a WavLM or HuBERT forward of the PyTorch + CUDA port spends its
time, on one GPU.

    python3 tools/torch_wavlm_breakdown.py [--model wavlm|hubert|wavlm_base|hubert_base]
                                           [--out FILE]

For each path of the model at B=32 x 10 s, B=8 x 30 s and B=4 x 60 s
(full-length utterances, random weights from seed 0) it times with CUDA
events (mean of 5 after a warm-up): the whole forward
(`apply_standardized`), the front end (wave normalisation, where the model
has it, and the conv extractor; for the Base models' group-norm extractor
also its parts: the stock conv0, the f32 group norm + GELU, the six stock
mid convs + GELU), the feature LN and projection, the pos-conv, WavLM's
shared pos_bias gather, the encoder LN, and the parts of one encoder layer
(layer 0 alone, times the layer count: 24 Large, 12 Base) on the route that
path takes:
- WavLM, int8 (the serving default) and bf16: the LN before the attention,
  the gate, the QKV projection, the head split, K9/K10, the head merge,
  the out-projection with the residual, the FFN block; ``wavlm_fuse`` (10
  and 30 s): K11 in place of the split, K9, the merge and the out-proj;
- HuBERT, int8: K1 (T <= 512) or the LN, the stock QKV and K6 (K8 and
  stock ops beyond 2,048 frames), then K2; ``qkv_fuse`` (30 and 60 s): K12
  in place of the LN and the stock QKV; ``full_fuse``: K12 (LN + QKV), K7
  (K8 beyond 2,048), K12 (out-proj + residual), K2; bf16: K4 and K5, or
  beyond 512 frames the LN, cuBLAS QKV, K7/K8, cuBLAS out-proj, K5;
- the post-LN Base models: HuBERT-Base int8 K1 postnorm (T <= 512) or the
  stock QKV on raw x, K6 (K8 and stock ops beyond 2,048) and the LN, then
  K2 postnorm; bf16 K4 postnorm or cuBLAS QKV, K7/K8, cuBLAS out-proj and
  the LN, then K5 postnorm; WavLM-Base as WavLM on raw x, each sum followed
  by its LN, the FFN int8 K2 bare, bf16 the module path.
A part of a few small launches (WavLM's gate) is bound by the host's launch
rate when it is timed alone; in a forward those launches overlap the
device's work. The device's idle share is 1 - (the profiler's summed
kernel time over 3 forwards) / (their event time). Prints one line per part
and writes the table as JSON. Imports torch and the port only.
"""

import argparse
import json
import os
import subprocess
import sys

import torch

SR = 16000
BATCHES = (("10 s", 32, 10), ("30 s", 8, 30), ("60 s", 4, 60))
ENTRIES = {"wavlm": "wavlm_large", "hubert": "hubert_large_ll60k",
           "wavlm_base": "wavlm_base", "hubert_base": "hubert_base"}
EVERY = ("10 s", "30 s", "60 s")
# model -> path -> (hub.load keywords, the batches it is timed at)
PATHS = {
    "wavlm": {"int8": ({}, ("10 s", "30 s", "60 s")),
              "int8 wavlm_fuse": ({"wavlm_fuse": True}, ("10 s", "30 s")),
              "bf16": ({}, ("10 s", "30 s", "60 s"))},
    "hubert": {"int8": ({}, ("10 s", "30 s", "60 s")),
               "int8 qkv_fuse": ({"qkv_fuse": True}, ("30 s", "60 s")),
               "int8 full_fuse": ({"full_fuse": True}, ("10 s", "30 s", "60 s")),
               "bf16": ({}, ("10 s", "30 s", "60 s"))},
    "wavlm_base": {"int8": ({}, EVERY), "int8 wavlm_fuse": ({"wavlm_fuse": True}, ("10 s", "30 s")),
                   "bf16": ({}, EVERY)},
    "hubert_base": {"int8": ({}, EVERY), "bf16": ({}, EVERY)},
}


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


def wavlm_parts(layer, x, kv, pos_bias):
    """(name, fn) of one WavLM layer's parts on its route."""
    from s3prl_tpu_torch.kernels import flash_attention as fa
    from s3prl_tpu_torch.kernels.ffn import fused_int8_ffn
    from s3prl_tpu_torch.models.transformer import _layer_norm, _linear
    from s3prl_tpu_torch.ops.quant import int8_matmul

    attn, ln1, ln2 = layer.self_attn, layer.self_attn_layer_norm, layer.final_layer_norm
    B, T, _ = x.shape
    pre = layer.layer_norm_first
    h = _layer_norm(x, ln1) if pre else x  # post-LN: the attention on raw x
    gate = attn.gate(h)

    def qkv_proj():
        if layer.quantize:
            return int8_matmul(h, attn.qpair("qkv"), attn.qkv_bias)
        return torch.nn.functional.linear(h, attn.qkv_weight, attn.qkv_bias.to(h.dtype))

    def ffn():
        if not pre:  # LN2(x + ffn(x)): K2 bare or the module path
            bare = fused_int8_ffn(x, layer.qpair("fc1"), layer.fc1.bias, layer.qpair("fc2"),
                                  layer.fc2.bias) if layer.quantize else layer._ffn(x)
            return _layer_norm(x + bare, ln2)
        if layer.quantize:
            return fused_int8_ffn(x, layer.qpair("fc1"), layer.fc1.bias, layer.qpair("fc2"),
                                  layer.fc2.bias, ln=(ln2.weight, ln2.bias), residual=True)
        return x + layer._ffn(_layer_norm(x, ln2))

    qkv = qkv_proj()
    head = [(f"- LN {'before' if pre else 'after'} the attention", lambda: _layer_norm(x, ln1)),
            ("- gate (grep_linear, sigmoid, in the model dtype; f32 cast)",
             lambda: attn.gate(h).float()),
            ("- QKV projection", qkv_proj)]
    if layer.wavlm_fuse:
        return head + [
            ("- K11: attention + out-projection + residual (K10 + stock beyond 2,048)",
             lambda: fa.gated_bias_attention_outproj(qkv, x, pos_bias, gate.float(),
                                                     attn.qpair("out_proj"), attn.out_proj.bias,
                                                     kv, attn.num_heads)),
            ("- FFN block (K2; post-LN: K2 bare + LN)", ffn)]
    q, k, v = fa._split_heads(qkv, attn.num_heads)
    out = fa.gated_bias_attention(q, k, v, pos_bias, gate.float(), kv)
    ctx = out.transpose(1, 2).reshape(B, T, -1)

    def out_proj():
        if layer.quantize:
            return x + int8_matmul(ctx, attn.qpair("out_proj"), attn.out_proj.bias)
        return x + _linear(ctx, attn.out_proj)

    return head + [
        ("- heads split out of [B, T, 3C]", lambda: fa._split_heads(qkv, attn.num_heads)),
        ("- attention: K9 (K10 beyond 2,048 frames)",
         lambda: fa.gated_bias_attention(q, k, v, pos_bias, gate.float(), kv)),
        ("- heads merged into [B, T, C]", lambda: out.transpose(1, 2).reshape(B, T, -1)),
        ("- out-projection + residual", out_proj),
        ("- FFN block (K2 / LN + module path; post-LN: K2 bare / module path, + LN)", ffn)]


def hubert_post_ln_parts(layer, x, kv):
    """(name, fn) of one post-LN HuBERT layer's parts on its route."""
    from s3prl_tpu_torch.kernels import flash_attention as fa
    from s3prl_tpu_torch.kernels.ffn import fused_bf16_ffn, fused_int8_ffn
    from s3prl_tpu_torch.models.transformer import _layer_norm, _linear
    from s3prl_tpu_torch.ops.quant import int8_matmul

    attn, ln1, ln2 = layer.self_attn, layer.self_attn_layer_norm, layer.final_layer_norm
    H, ln, post = layer.num_heads, (ln1.weight, ln1.bias), dict(residual=True, postnorm=True)
    if layer.quantize:
        ffn = ("- FFN block: K2 postnorm", lambda: fused_int8_ffn(
            x, layer.qpair("fc1"), layer.fc1.bias, layer.qpair("fc2"), layer.fc2.bias,
            ln=(ln2.weight, ln2.bias), **post))
    else:
        ffn = ("- FFN block: K5 postnorm", lambda: fused_bf16_ffn(
            x, layer.fc1.weight, layer.fc1.bias, layer.fc2.weight, layer.fc2.bias,
            ln=(ln2.weight, ln2.bias), **post))
    if x.shape[1] <= fa.MAX_BLOCK_T:
        if layer.quantize:
            return [("- attention block: K1 postnorm", lambda: fa.fused_attention_block(
                x, attn.qpair("qkv"), attn.qkv_bias, ln, attn.qpair("out_proj"),
                attn.out_proj.bias, kv, H, postnorm=True)), ffn]
        return [("- attention block: K4 postnorm", lambda: fa.fused_attention_block_bf16(
            x, attn.qkv_weight, attn.qkv_bias, ln, attn.out_proj.weight, attn.out_proj.bias,
            kv, H, postnorm=True)), ffn]
    ln_after = ("- LN after the attention", lambda: _layer_norm(x, ln1))
    if layer.quantize:
        qkv = int8_matmul(x, attn.qpair("qkv"), attn.qkv_bias, out_dtype=x.dtype)
        return [("- QKV on raw x: stock int8_matmul", lambda: int8_matmul(
            x, attn.qpair("qkv"), attn.qkv_bias, out_dtype=x.dtype)),
            ("- attention + out-projection + residual: K6 (K8 + stock beyond 2,048)",
             lambda: fa.fused_qkv_attention_outproj(qkv, x, attn.qpair("out_proj"),
                                                    attn.out_proj.bias, kv, H)),
            ln_after, ffn]
    qkv = torch.nn.functional.linear(x, attn.qkv_weight, attn.qkv_bias.to(x.dtype))
    out = fa.fused_qkv_attention(qkv, kv, H)
    return [("- QKV on raw x: cuBLAS", lambda: torch.nn.functional.linear(
        x, attn.qkv_weight, attn.qkv_bias.to(x.dtype))),
        ("- attention: K7 (K8 beyond 2,048)", lambda: fa.fused_qkv_attention(qkv, kv, H)),
        ("- out-projection + residual: cuBLAS", lambda: x + _linear(out, attn.out_proj)),
        ln_after, ffn]


def extractor_parts(fe, wavs):
    """(name, fn) of the group-norm extractor's parts (stock ops only)."""
    from s3prl_tpu_torch.models.convfe import group_norm_f32

    first, *rest = fe.conv_layers
    x = wavs[..., None].to(fe.dtype)
    y = first.conv_out(x)
    h = first(x, "tanh" if fe.quantize else "erf")

    def mid():
        z = h
        for layer in rest:
            z = layer(z, "tanh" if fe.quantize else "erf")
        return z

    return [("- conv0 (stock F.conv1d, C_in 1)", lambda: first.conv_out(x)),
            ("- group norm (f32, cast) + GELU", lambda: torch.nn.functional.gelu(
                group_norm_f32(y, first.norm).to(y.dtype))),
            ("- six mid convs + GELU (stock)", mid)]


def hubert_parts(layer, x, kv):
    """(name, fn) of one HuBERT layer's parts on its route."""
    from s3prl_tpu_torch.kernels import flash_attention as fa
    from s3prl_tpu_torch.kernels.ffn import fused_bf16_ffn, fused_int8_ffn, fused_int8_linear
    from s3prl_tpu_torch.models.transformer import _layer_norm, _linear
    from s3prl_tpu_torch.ops.quant import int8_matmul

    if not layer.layer_norm_first:
        return hubert_post_ln_parts(layer, x, kv)
    attn, ln1, ln2 = layer.self_attn, layer.self_attn_layer_norm, layer.final_layer_norm
    H, ln = layer.num_heads, (ln1.weight, ln1.bias)
    short = x.shape[1] <= fa.MAX_BLOCK_T
    if layer.quantize:
        ffn = ("- FFN block: K2", lambda: fused_int8_ffn(
            x, layer.qpair("fc1"), layer.fc1.bias, layer.qpair("fc2"), layer.fc2.bias,
            ln=(ln2.weight, ln2.bias), residual=True))
    else:
        ffn = ("- FFN block: K5", lambda: fused_bf16_ffn(
            x, layer.fc1.weight, layer.fc1.bias, layer.fc2.weight, layer.fc2.bias,
            ln=(ln2.weight, ln2.bias), residual=True))
    k12_qkv = ("- LN + QKV: K12",
               lambda: fused_int8_linear(x, attn.qpair("qkv"), attn.qkv_bias, ln=ln))
    if layer.quantize and layer.full_fuse:
        qkv = k12_qkv[1]()
        a = fa.fused_qkv_attention(qkv, kv, H)
        return [k12_qkv,
                ("- attention: K7 (K8 beyond 2,048)", lambda: fa.fused_qkv_attention(qkv, kv, H)),
                ("- out-projection + residual: K12", lambda: fused_int8_linear(
                    a, attn.qpair("out_proj"), attn.out_proj.bias, residual=x)),
                ffn]
    if layer.quantize and short:
        return [("- attention block: K1", lambda: fa.fused_attention_block(
            x, attn.qpair("qkv"), attn.qkv_bias, ln, attn.qpair("out_proj"), attn.out_proj.bias,
            kv, H)), ffn]
    if not layer.quantize and short:
        return [("- attention block: K4", lambda: fa.fused_attention_block_bf16(
            x, attn.qkv_weight, attn.qkv_bias, ln, attn.out_proj.weight, attn.out_proj.bias,
            kv, H)), ffn]
    h = _layer_norm(x, ln1)
    parts = [("- LN before the attention", lambda: _layer_norm(x, ln1))]
    if not layer.quantize:
        qkv = torch.nn.functional.linear(h, attn.qkv_weight, attn.qkv_bias.to(h.dtype))
        out = fa.fused_qkv_attention(qkv, kv, H)
        return parts + [
            ("- QKV: cuBLAS", lambda: torch.nn.functional.linear(
                h, attn.qkv_weight, attn.qkv_bias.to(h.dtype))),
            ("- attention: K7 (K8 beyond 2,048)", lambda: fa.fused_qkv_attention(qkv, kv, H)),
            ("- out-projection + residual: cuBLAS", lambda: x + _linear(out, attn.out_proj)),
            ffn]
    if layer.qkv_fuse:
        parts, qkv_part = [], k12_qkv
    else:
        qkv_part = ("- QKV: stock int8_matmul", lambda: int8_matmul(
            h, attn.qpair("qkv"), attn.qkv_bias, out_dtype=x.dtype))
    qkv = qkv_part[1]()
    return parts + [qkv_part, (
        "- attention + out-projection + residual: K6 (K8 + stock beyond 2,048)",
        lambda: fa.fused_qkv_attention_outproj(qkv, x, attn.qpair("out_proj"),
                                               attn.out_proj.bias, kv, H)), ffn]


@torch.inference_mode()
def breakdown(model_name, path, B, secs, dev):
    from s3prl_tpu_torch import hub
    from s3prl_tpu_torch.models.transformer import _layer_norm, _linear
    from s3prl_tpu_torch.models.wav2vec2 import normalize_wavs

    options = PATHS[model_name][path][0]
    up = hub.load(ENTRIES[model_name], dtype=torch.bfloat16, flash=True,
                  quantize=path != "bf16", device=dev, seed=0, **options)
    model, enc = up.model, up.model.encoder
    n = int(secs * SR)
    wavs = torch.randn(B, n, generator=torch.Generator().manual_seed(1)).to(dev)
    lens = torch.full((B,), n, device=dev)
    parts = {"forward": cuda_ms(lambda: up.apply_standardized(wavs, lens))}

    def waves():
        return normalize_wavs(wavs, lens) if model.cfg.normalize else wavs

    parts["front end (normalize + extractor)"] = cuda_ms(
        lambda: model.feature_extractor(waves()))
    if model.cfg.extractor_mode == "default":
        for name, fn in extractor_parts(model.feature_extractor, waves()):
            parts[name] = cuda_ms(fn)
    feats = model.feature_extractor(waves())
    T = feats.shape[1]

    def proj():
        f = torch.nn.functional.layer_norm(feats.float(), (feats.shape[-1],),
                                           model.layer_norm.weight, model.layer_norm.bias,
                                           eps=1e-5).to(model.dtype)
        return _linear(f, model.post_extract_proj)

    parts["feature LN + projection"] = cuda_ms(proj)
    x = proj()
    parts["pos-conv"] = cuda_ms(lambda: x + enc.pos_conv(x))
    shared = enc._layer_args(T, x.device)
    wavlm = model_name.startswith("wavlm")
    if wavlm:
        parts["pos_bias gather (once per forward)"] = cuda_ms(
            lambda: enc._layer_args(T, x.device))
    kv = torch.full((B,), T, dtype=torch.int32, device=dev)
    pad = torch.zeros(B, T, dtype=torch.bool, device=dev)
    layer = enc.layers[0]
    L = len(enc.layers)
    parts[f"{L} encoder layers (layer 0 alone x {L})"] = L * cuda_ms(
        lambda: layer(x, kv, pad, *shared))
    layer_parts = (wavlm_parts(layer, x, kv, *shared) if wavlm
                   else hubert_parts(layer, x, kv))
    for name, fn in layer_parts:
        parts[name] = L * cuda_ms(fn)
    # the encoder LN: after the layers when pre-LN, before them when post-LN
    parts["encoder LN"] = cuda_ms(lambda: _layer_norm(x, enc.layer_norm))
    idle, busy = idle_share(lambda: up.apply_standardized(wavs, lens))
    parts["idle share"] = idle
    parts["profiler kernel time / event time"] = busy
    del up, model, enc
    torch.cuda.empty_cache()
    return T, parts


def main():
    parser = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    parser.add_argument("--model", choices=sorted(PATHS), default="wavlm")
    parser.add_argument("--out", default=None,
                        help="JSON table (default build/<model>_breakdown.json)")
    args = parser.parse_args()
    if not torch.cuda.is_available():
        raise SystemExit("torch_wavlm_breakdown: no CUDA device")
    sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, check=True, timeout=60).stdout.strip()
    print(smi.splitlines()[0], flush=True)
    table = {"card": smi.splitlines()[0], "model": args.model, "columns": {}}
    for path, (_, lengths) in PATHS[args.model].items():
        for label, B, secs in BATCHES:
            if label not in lengths:
                continue
            T, parts = breakdown(args.model, path, B, secs, torch.device("cuda"))
            column = f"{path} B={B} x {label} (T'={T})"
            table["columns"][column] = parts
            for name, value in parts.items():
                print(f"[breakdown] {args.model} {column} {name}: {value:.4f}", flush=True)
    out = args.out or f"build/{args.model}_breakdown.json"
    os.makedirs(os.path.dirname(out) or ".", exist_ok=True)
    with open(out, "w") as f:
        json.dump(table, f, indent=1)


if __name__ == "__main__":
    main()
