"""s3prl_tpu_torch — the PyTorch + CUDA port of s3prl_tpu for one NVIDIA H100.

The JAX package `s3prl_tpu` stays the reference; this package mirrors its
module names (`models/`, `kernels/`, `ops/`, `upstream/`, `hub`) and replaces
each Pallas kernel on its path with a CUDA kernel written for Hopper
(`csrc/*.cu`, built at first use by `kernels/_build.py`). CPU tensors run each
kernel's plain PyTorch version. It never imports jax.

    from s3prl_tpu_torch import hub
    up = hub.load("hubert_large_ll60k", dtype=torch.bfloat16, flash=True,
                  device="cuda")
    hs, h_lens = up.apply_standardized(wavs, wav_lens)  # [25, B, T', 1024]
"""

__version__ = "0.1.0"

SAMPLE_RATE = 16000
