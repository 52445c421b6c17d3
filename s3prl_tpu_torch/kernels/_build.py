"""Build the port's CUDA kernels into one shared library and bind it.

`library()` compiles every ``s3prl_tpu_torch/csrc/*.cu`` with one ``nvcc``
call for ``sm_90a`` into ``build/s3prl_tpu_torch/<hash of the sources>/`` at
the root of the checkout, loads the result with ``ctypes`` and declares each
C entry's argument types. The entries take device pointers and the CUDA
stream as ``void*`` and ints as ``int``, and return ``cudaGetLastError()``
after their launch; ``launch`` raises when that is not 0.

Nothing here runs at import, and nothing runs for CPU tensors: the kernel
wrappers call ``launch`` only for CUDA tensors. A build is a plain C
interface (no PyTorch headers), so it takes seconds, not minutes.
"""

from __future__ import annotations

import ctypes
import functools
import hashlib
import os
import shutil
import subprocess
import tempfile
from pathlib import Path

CSRC = Path(__file__).resolve().parent.parent / "csrc"
BUILD_ROOT = Path(__file__).resolve().parents[2] / "build" / "s3prl_tpu_torch"
LIB_NAME = "libs3prl_tpu_torch.so"
NVCC_FLAGS = (
    "-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
    "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v",
)

_P, _I, _F = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
# C entry -> argument types (pointers and the stream as void*, ints as int)
SIGNATURES = {
    # wav, weight, gamma, beta, out, batch, n_samples, n_frames, is_bf16, stream
    "s3_conv0_ln_gelu": (_P, _P, _P, _P, _P, _I, _I, _I, _I, _P),
    # x, x_is_f32, gamma, beta, out, rows, cols, eps, stream
    "s3_layernorm": (_P, _I, _P, _P, _P, _I, _I, _F, _P),
    # a, w, bias, res, out, out_f32, gelu, M, N, K, stream
    "s3_gemm_bf16": (_P, _P, _P, _P, _P, _I, _I, _I, _I, _I, _P),
    # qkv, kv_lens, out, batch, T, heads, scale, stream
    "s3_attention": (_P, _P, _P, _I, _I, _I, _F, _P),
}


def sources() -> list[Path]:
    return sorted(CSRC.glob("*.cu")) + sorted(CSRC.glob("*.cuh"))


def _digest() -> str:
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for path in sources():
        h.update(path.name.encode())
        h.update(path.read_bytes())
    return h.hexdigest()[:16]


def _nvcc() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    cuda_home = os.environ.get("CUDA_HOME") or "/usr/local/cuda"
    candidate = Path(cuda_home) / "bin" / "nvcc"
    if candidate.exists():
        return str(candidate)
    raise RuntimeError(
        "nvcc not found (looked on PATH and in $CUDA_HOME/bin): the CUDA "
        "kernels build only on a machine with the CUDA toolkit")


def build() -> Path:
    """Compiles the sources unless this hash is already built; returns the
    library path. The compiler's output (``-Xptxas -v``: registers, shared
    memory, spills per kernel) is kept beside it as ``nvcc.log``."""
    out_dir = BUILD_ROOT / _digest()
    lib = out_dir / LIB_NAME
    if lib.exists():
        return lib
    out_dir.mkdir(parents=True, exist_ok=True)
    cu = [str(p) for p in sources() if p.suffix == ".cu"]
    with tempfile.TemporaryDirectory(dir=out_dir) as tmp:
        tmp_lib = Path(tmp) / LIB_NAME
        cmd = [_nvcc(), *NVCC_FLAGS, "-o", str(tmp_lib), *cu]
        proc = subprocess.run(cmd, capture_output=True, text=True, check=False)
        (out_dir / "nvcc.log").write_text(
            " ".join(cmd) + "\n" + proc.stdout + proc.stderr)
        if proc.returncode != 0:
            raise RuntimeError(
                f"nvcc failed ({proc.returncode}):\n{proc.stderr[-4000:]}")
        os.replace(tmp_lib, lib)  # atomic: a concurrent loader sees all or nothing
    return lib


@functools.lru_cache(maxsize=None)
def library() -> ctypes.CDLL:
    """The loaded kernel library (built at first use), one per process."""
    lib = ctypes.CDLL(str(build()))
    for name, argtypes in SIGNATURES.items():
        fn = getattr(lib, name)
        fn.argtypes = list(argtypes)
        fn.restype = ctypes.c_int
    lib.s3_error_string.argtypes = [ctypes.c_int]
    lib.s3_error_string.restype = ctypes.c_char_p
    return lib


def launch(name: str, *args) -> None:
    """Calls C entry `name`; raises when its launch reported a CUDA error."""
    lib = library()
    err = getattr(lib, name)(*args)
    if err != 0:
        raise RuntimeError(
            f"{name}: CUDA error {err} ({lib.s3_error_string(err).decode()})")
