"""Build the port's CUDA kernels into one shared library and bind it.

`library()` compiles every ``s3prl_tpu_torch/csrc/*.cu`` for ``sm_90a``,
one ``nvcc -c`` per source, all started together, links the objects into
one library in ``build/s3prl_tpu_torch/<hash of the sources>/`` at the root
of the checkout, loads it with ``ctypes`` and declares each
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
    "-Xcompiler", "-fPIC", "-Xptxas", "-v",
)

_P, _I, _L, _F = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong, ctypes.c_float
# C entry -> argument types (pointers and the stream as void*, ints as int,
# element offsets as long long)
SIGNATURES = {
    # wav, weight, gamma, beta, out, batch, n_samples, n_frames, is_bf16, tanh_mode, stream
    "s3_conv0_ln_gelu": (_P, _P, _P, _P, _P, _I, _I, _I, _I, _I, _P),
    # wav, weight, gamma, beta, q, scale, batch, n_samples, n_frames, is_bf16, stream
    "s3_conv0_ln_gelu_q8": (_P, _P, _P, _P, _P, _P, _I, _I, _I, _I, _P),
    # kind (0-2 bf16 waves: erf, tanh, q8; 3-5 f32 waves), &smem_bytes, &blocks_per_sm
    "s3_conv0_occupancy": (_I, _P, _P),
    # x, x_is_f32, gamma, beta, tanh_mode, out, out_kind, scale, rows, stream
    "s3_ln_gelu": (_P, _I, _P, _P, _I, _P, _I, _P, _I, _P),
    # x, x_is_f32, gamma, beta, out, rows, cols, eps, stream
    "s3_layernorm": (_P, _I, _P, _P, _P, _I, _I, _F, _P),
    # a, lda, a_rows, a_gstride, w, bias, res, out, out_f32, gelu, M, N, K, stream
    "s3_gemm_bf16": (_P, _I, _I, _L, _P, _P, _P, _P, _I, _I, _I, _I, _I, _P),
    # q, k, v, kv_lens, out, batch, heads, T, stream
    "s3_online_attention": (_P, _P, _P, _P, _P, _I, _I, _I, _P),
    # q, k, v, pos_bias, bias_f32, bias_ld, gate, kv_lens, out, batch, heads, T, masked,
    # l_floor, stream
    "s3_gated_attention": (_P, _P, _P, _P, _I, _I, _P, _P, _P, _I, _I, _I, _F, _F, _P),
    # qkv, kv_lens, out, batch, T, heads, scale, out_f32, stream
    "s3_qkv_attention": (_P, _P, _P, _I, _I, _I, _F, _I, _P),
    # qkv, kv_lens, pos_bias, bias_ld, gate, out, batch, T, heads, scale, stream (f32 out)
    "s3_qkv_attention_gated": (_P, _P, _P, _I, _P, _P, _I, _I, _I, _F, _P),
    # kind (0 no bias, 1 bf16 bias, 2 f32 bias, 3 packed bf16 out, 4 packed f32 out,
    # 5 packed f32 bias f32 out), &smem_bytes, &blocks_per_sm
    "s3_gated_attention_occupancy": (_I, _P, _P),
    # q, k, v, kv_lens, out, batch, heads, T, stream
    "s3_flash_attention": (_P, _P, _P, _P, _P, _I, _I, _I, _P),
    # &smem_bytes, &blocks_per_sm
    "s3_gemm_s8_occupancy": (_P, _P),
    # &smem_bytes, &blocks_per_sm
    "s3_gemm_bf16_occupancy": (_P, _P),
    # k, &smem_bytes, &blocks_per_sm (K16a; K16b on bf16 x)
    "s3_posconv_occupancy": (_I, _P, _P),
    "s3_posconv_q8_occupancy": (_I, _P, _P),
    # x, x_is_f32, q (or null: the scales alone), xs, batch, T, C, stream
    "s3_posconv_quant": (_P, _I, _P, _P, _I, _I, _I, _P),
    # x, w, bias, xs, ws, out, q8, out_f32, batch, T, C, k, stream
    "s3_posconv": (_P, _P, _P, _P, _P, _P, _I, _I, _I, _I, _I, _I, _P),
    # x, w, bias, xs, ws, out, out_f32, codes, batch, T, C, k, stream
    "s3_posconv_q8_codes": (_P, _P, _P, _P, _P, _P, _I, _P, _I, _I, _I, _I, _P),
    # a, lda, a_rows, a_gstride, w, ldw, M, N, K, row_scale, col_scale, bias,
    # acc_in, res, out, mode, gelu, out_f32, stream
    "s3_gemm_s8": (_P, _I, _I, _L, _P, _I, _I, _I, _I, _P, _P, _P, _P, _P, _P, _I, _I, _I, _P),
    # x, x_is_f32, ld, lo, hi, gamma, beta, eps, q, scale, rows, stream
    "s3_quant_rows": (_P, _I, _I, _I, _I, _P, _P, _F, _P, _P, _I, _P),
    # x, cols, q, scale, rows, stream
    "s3_quant_rows_bf16": (_P, _I, _P, _P, _I, _P),
    # x, x_is_f32, M, C, rule, gamma, beta, eps, w, N, col_scale, bias, res, out, mode,
    # out_f32, q_out, s_out, stats_out, stream
    "s3_int8_panel": (_P, _I, _I, _I, _I, _P, _P, _F, _P, _I, _P, _P, _P, _P, _I, _I, _P, _P,
                      _P, _P),
    # &smem_bytes, &blocks_per_sm
    "s3_int8_panel_occupancy": (_P, _P),
    # xq, xs, wq, ws, gamma, beta, batch, T, T', k, out, scale, out_f32, sum_out, stats_out,
    # stream
    "s3_int8_conv": (_P, _P, _P, _P, _P, _P, _I, _I, _I, _I, _P, _P, _I, _P, _P, _P),
    # &smem_bytes, &blocks_per_sm
    "s3_int8_conv_occupancy": (_P, _P),
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
    nvcc = _nvcc()
    cu = [p for p in sources() if p.suffix == ".cu"]
    log = []
    with tempfile.TemporaryDirectory(dir=out_dir) as tmp:
        objs = [Path(tmp) / f"{p.stem}.o" for p in cu]
        cmds = [[nvcc, *NVCC_FLAGS, "-c", str(src), "-o", str(obj)]
                for src, obj in zip(cu, objs)]
        procs = [subprocess.Popen(c, stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
                                  text=True) for c in cmds]
        failed = []
        for c, proc in zip(cmds, procs):
            out, _ = proc.communicate()
            log.append(" ".join(c) + "\n" + out)
            if proc.returncode != 0:
                failed.append(f"{Path(c[-3]).name} ({proc.returncode}):\n{out[-4000:]}")
        tmp_lib = Path(tmp) / LIB_NAME
        if not failed:
            link = [nvcc, "-shared", "-o", str(tmp_lib), *map(str, objs)]
            proc = subprocess.run(link, capture_output=True, text=True, check=False)
            log.append(" ".join(link) + "\n" + proc.stdout + proc.stderr)
            if proc.returncode != 0:
                failed.append(f"link ({proc.returncode}):\n{proc.stderr[-4000:]}")
        (out_dir / "nvcc.log").write_text("\n".join(log))
        if failed:
            raise RuntimeError("nvcc failed: " + "\n".join(failed))
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
