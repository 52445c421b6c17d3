#!/usr/bin/env python3
"""SUPERB's frame probes, query-by-example, HEAR and MOS on the card,
alone: phase 10 of `chip_smoke.py` (QbeDTW's extraction at B = 1 of 8
queries and 32 documents up to 30 s and its DTW against the CPU; the
TimitPhoneConvBank, QbE embedder, HEAR scene, HEAR event and MOS heads over
HuBERT-Large int8 on their fixed batches with their launch counts, one
update of each against the CPU, each step and the frozen forward timed
with the peak device memory and the idle share; then the Example recipes
and a HEAR k-fold recipe through Problem.run) after building the kernels,
in a few minutes in place of the whole script's. Run from the repository's
root:

    python3 tools/torch_recipes_step.py
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
        raise SystemExit("torch_recipes_step: no CUDA device")
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
    with chip_smoke.Phase("recipes"):
        chip_smoke.recipes_phase(wrapper, torch.Generator().manual_seed(0), torch.device("cuda"),
                                 smi.splitlines()[0])


if __name__ == "__main__":
    main()
