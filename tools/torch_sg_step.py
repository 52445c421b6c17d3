#!/usr/bin/env python3
"""The baseline front ends and SUPERB-SG's SE, SS and ST on the card,
alone: phase 11 of `chip_smoke.py` (the six baseline entries against the
CPU, the STFT round trip, the fbank entry, STFT and iSTFT timed; the SS,
SE and ST heads over HuBERT-Large int8 on their fixed batches with their
launch counts, the loss falling, one update of each against the CPU, each
step and the frozen forward timed with the peak device memory and the idle
share, ST's greedy decoding timed and against the CPU; then SeExample and
StExample through Problem.run) after building the kernels, in a few
minutes in place of the whole script's. Run from the repository's root:

    python3 tools/torch_sg_step.py
"""

import os
import subprocess
import sys
import time


def main():
    root = os.path.join(os.path.dirname(os.path.abspath(__file__)), "..")
    sys.path.insert(0, os.path.abspath(root))
    import torch

    if not torch.cuda.is_available():
        raise SystemExit("torch_sg_step: no CUDA device")
    import chip_smoke
    from s3prl_tpu_torch.kernels import _build, wrappers

    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, check=True, timeout=60).stdout.strip()
    print(smi, torch.__version__, torch.version.cuda, flush=True)
    torch.backends.cuda.matmul.allow_tf32 = False  # as chip_smoke.py runs it
    torch.backends.cudnn.allow_tf32 = False
    t0 = time.perf_counter()
    _build.library()
    print(f"build {time.perf_counter() - t0:.1f} s", flush=True)
    wrapper = {w.__name__: w for w in wrappers()}
    with chip_smoke.Phase("sg recipes"):
        chip_smoke.sg_phase(wrapper, torch.Generator().manual_seed(0), torch.device("cuda"),
                            smi.splitlines()[0])


if __name__ == "__main__":
    main()
