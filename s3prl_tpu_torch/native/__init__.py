"""The port's host-side C++ libraries: the FLAC decoder (``flac_decode.cc``,
bound in data/flac.py) and the CTC prefix beam decoder (``ctc_beam.cc``,
bound in nn/beam_decoder.py), copies of the JAX package's sources.

`library(name)` compiles ``native/<name>.cc`` with ``g++`` at first use into
``build/s3prl_tpu_torch/native/<hash of the source>/lib<name>.so`` at the root
of the checkout and loads it with ``ctypes``. A failed build raises with the
compiler's output. Nothing runs at import.
"""

from __future__ import annotations

import ctypes
import functools
import hashlib
import os
import subprocess
import tempfile
from pathlib import Path

SRC = Path(__file__).resolve().parent
BUILD_ROOT = Path(__file__).resolve().parents[2] / "build" / "s3prl_tpu_torch" / "native"
FLAGS = ("-O3", "-shared", "-fPIC", "-std=c++17")


def build(name: str) -> Path:
    """Compiles ``<name>.cc`` unless this source is already built; returns
    the library path."""
    src = SRC / f"{name}.cc"
    h = hashlib.sha256(" ".join(FLAGS).encode())
    h.update(src.read_bytes())
    out_dir = BUILD_ROOT / h.hexdigest()[:16]
    lib = out_dir / f"lib{name}.so"
    if lib.exists():
        return lib
    out_dir.mkdir(parents=True, exist_ok=True)
    with tempfile.TemporaryDirectory(dir=out_dir) as tmp:
        tmp_lib = Path(tmp) / lib.name
        cmd = ["g++", *FLAGS, str(src), "-o", str(tmp_lib)]
        proc = subprocess.run(cmd, capture_output=True, text=True, check=False)
        if proc.returncode != 0:
            raise RuntimeError(f"g++ failed to build {src.name} ({proc.returncode}):\n"
                               f"{proc.stderr[-4000:]}")
        os.replace(tmp_lib, lib)  # atomic: a concurrent loader sees all or nothing
    return lib


@functools.lru_cache(maxsize=None)
def library(name: str) -> ctypes.CDLL:
    """The loaded library of ``<name>.cc`` (built at first use), one per process."""
    return ctypes.CDLL(str(build(name)))
