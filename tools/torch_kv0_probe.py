#!/usr/bin/env python3
"""Rows with kv_len 0 through the split-head attention kernels (K8, K9, K10,
K17) of a checkout, on the card: the NaN count of such a row and its
largest distance from the mean of the values, which the plain versions
give it. Run from the checkout's root, or give its path:

    python3 tools/torch_kv0_probe.py [--root DIR]

(an utterance under 400 samples has no frame under wav2vec2's conv length
rule, so its attention rows have no valid key)."""

import argparse
import os
import sys


def main():
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--root", default=os.path.join(os.path.dirname(os.path.abspath(__file__)),
                                                   ".."))
    sys.path.insert(0, os.path.abspath(ap.parse_args().root))
    import torch

    from s3prl_tpu_torch.kernels import flash_attention as fa

    if not torch.cuda.is_available():
        raise SystemExit("torch_kv0_probe: no CUDA device")
    g = torch.Generator().manual_seed(0)
    B, H, T = 2, 16, 499
    q, k, v = (torch.randn(B, H, T, 64, generator=g).cuda().bfloat16() for _ in range(3))
    q = q * 0.125
    bias = torch.randn(H, T, T, generator=g).cuda()
    gate = (1 + 2 * torch.rand(B, H, T, generator=g)).cuda()
    kv = torch.tensor([T, 0], dtype=torch.int32, device="cuda")
    mean = v[1].float().mean(1, keepdim=True)
    for name, out in (("K8 online_flash_attention", fa.online_flash_attention(q, k, v, kv)),
                      ("K9 gated_bias_attention", fa.gated_bias_attention(q, k, v, bias, gate, kv)),
                      ("K10 gated_online_flash_attention",
                       fa.gated_online_flash_attention(q, k, v, bias, gate, kv)),
                      ("K17 flash_attention", fa.flash_attention(q, k, v, kv))):
        row = out[1].float()
        torch.cuda.synchronize()
        far = float((row - mean).abs().nan_to_num(float("inf")).max())
        print(f"[kv0] {name} [{B}, {H}, {T}, 64], kv_len 0 row: NaN {int(row.isnan().sum())} of "
              f"{row.numel()}, max |out - mean(v)| {far:.4f}, max |mean(v)| "
              f"{float(mean.abs().max()):.4f}")


if __name__ == "__main__":
    main()
