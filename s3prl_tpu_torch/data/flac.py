"""FLAC decoding and a minimal writer (a copy of s3prl_tpu/data/flac.py).

The decoder is the first-party C++ library native/flac_decode.cc, built
with g++ at first use into build/ (native/__init__.py) and bound through
ctypes. It gives LibriSpeech / VoxCeleb-style FLAC corpora a native decode
path without torchaudio/sox (reference decode path:
s3prl/run_downstream.py:157). `write_flac` writes spec-valid files (test
fixtures, small exports).
"""

from __future__ import annotations

import ctypes
import functools
import os
from pathlib import Path
from typing import Tuple

import numpy as np

from .. import native


@functools.lru_cache(maxsize=None)
def _lib():
    lib = native.library("flac_decode")
    lib.flac_info.restype = ctypes.c_int
    lib.flac_info.argtypes = [
        ctypes.c_char_p,
        ctypes.POINTER(ctypes.c_longlong),
        ctypes.POINTER(ctypes.c_int),
        ctypes.POINTER(ctypes.c_int),
        ctypes.POINTER(ctypes.c_int),
    ]
    lib.flac_decode.restype = ctypes.c_longlong
    lib.flac_decode.argtypes = [
        ctypes.c_char_p,
        ctypes.POINTER(ctypes.c_int32),
        ctypes.c_longlong,
    ]
    return lib


def flac_info(path) -> dict:
    n = ctypes.c_longlong()
    ch = ctypes.c_int()
    sr = ctypes.c_int()
    bits = ctypes.c_int()
    rc = _lib().flac_info(
        str(path).encode(), ctypes.byref(n), ctypes.byref(ch),
        ctypes.byref(sr), ctypes.byref(bits),
    )
    if rc != 0:
        raise ValueError(f"not a valid FLAC file: {path} (rc={rc})")
    return dict(
        sample_rate=sr.value,
        num_frames=n.value,
        num_channels=ch.value,
        bits_per_sample=bits.value,
        duration=n.value / max(sr.value, 1),
    )


def load_flac(path) -> Tuple[np.ndarray, int, int]:
    """Decode a FLAC file -> (int32 samples [frames, channels], sr, bps)."""
    info = flac_info(path)
    frames, channels = info["num_frames"], info["num_channels"]
    unknown_total = frames == 0
    if unknown_total:
        # total_samples may legitimately be 0 (unknown, streamed encoders);
        # start from a compressed-size bound and grow until the decode fits
        # (FLAC routinely compresses >2x, so a fixed bound can truncate)
        frames = os.path.getsize(path) * 8 // max(info["bits_per_sample"], 1) + 65536
    while True:
        out = np.zeros((frames * channels,), np.int32)
        got = _lib().flac_decode(
            str(path).encode(),
            out.ctypes.data_as(ctypes.POINTER(ctypes.c_int32)),
            frames,
        )
        if got < 0:
            raise ValueError(f"FLAC decode failed for {path} (rc={got})")
        if not (unknown_total and got == frames):
            break
        frames *= 2  # buffer filled exactly: may be truncated, retry bigger
    return (
        out[: got * channels].reshape(-1, channels),
        info["sample_rate"],
        info["bits_per_sample"],
    )


# ---------------------------------------------------------------------------
# Minimal FLAC writer — enough to produce spec-valid files (STREAMINFO +
# fixed-blocksize frames, verbatim or fixed-order-2 rice subframes, real
# CRC-8/CRC-16). Used for test fixtures and lightweight artifact export.
# ---------------------------------------------------------------------------


class _BitWriter:
    def __init__(self):
        self.bytes = bytearray()
        self.acc = 0
        self.nbits = 0

    def write(self, value: int, nbits: int):
        value &= (1 << nbits) - 1
        self.acc = (self.acc << nbits) | value
        self.nbits += nbits
        while self.nbits >= 8:
            self.nbits -= 8
            self.bytes.append((self.acc >> self.nbits) & 0xFF)
        self.acc &= (1 << self.nbits) - 1

    def align(self):
        if self.nbits:
            self.write(0, 8 - self.nbits)


def _crc8(data: bytes) -> int:
    crc = 0
    for b in data:
        crc ^= b
        for _ in range(8):
            crc = ((crc << 1) ^ 0x07) & 0xFF if crc & 0x80 else (crc << 1) & 0xFF
    return crc


def _crc16(data: bytes) -> int:
    crc = 0
    for b in data:
        crc ^= b << 8
        for _ in range(8):
            crc = ((crc << 1) ^ 0x8005) & 0xFFFF if crc & 0x8000 else (crc << 1) & 0xFFFF
    return crc


def _rice_residual(w: _BitWriter, res: np.ndarray):
    """method 0 (4-bit rice), partition order 0, per-spec zigzag + unary."""
    u = (np.abs(res.astype(np.int64)) * 2 - (res < 0)).astype(np.int64)
    mean = max(int(u.mean()) if len(u) else 0, 1)
    param = min(max(int(np.log2(mean)) if mean > 0 else 0, 0), 14)
    w.write(0, 2)   # rice coding method (4-bit params)
    w.write(0, 4)   # partition order 0
    w.write(param, 4)
    for v in u:
        q = int(v) >> param
        if q > 48:  # pathological sample: re-emit whole partition escaped
            raise OverflowError
        w.write(0, q)
        w.write(1, 1)
        w.write(int(v), param)


def _subframe(w: _BitWriter, x: np.ndarray, bps: int):
    w.write(0, 1)  # pad
    try:
        # build in a scratch writer so a rice overflow can fall back cleanly
        sub = _BitWriter()
        order = min(2, len(x) - 1) if len(x) > 1 else 0
        if order == 2:
            res = x[2:].astype(np.int64) - 2 * x[1:-1].astype(np.int64) + x[:-2].astype(np.int64)
        elif order == 1:
            res = np.diff(x.astype(np.int64))
        else:
            # FIXED order-0 predicts zero: the residual IS the samples
            # (block_size - order = len(x) values)
            res = x.astype(np.int64)
        sub.write(8 + order, 6)  # FIXED subframe type
        sub.write(0, 1)          # no wasted bits
        for i in range(order):
            sub.write(int(x[i]), bps)
        _rice_residual(sub, res)
        for b in sub.bytes:
            w.write(b, 8)
        if sub.nbits:
            w.write(sub.acc, sub.nbits)
    except OverflowError:  # fall back to verbatim
        w.write(1, 6)
        w.write(0, 1)
        for v in x:
            w.write(int(v), bps)


def write_flac(path, samples: np.ndarray, sample_rate: int, bps: int = 16,
               block_size: int = 4096):
    """samples: int array [frames] or [frames, channels]."""
    samples = np.asarray(samples)
    if samples.ndim == 1:
        samples = samples[:, None]
    frames, channels = samples.shape
    head = _BitWriter()
    head.bytes += b"fLaC"
    head.write(1, 1)    # last metadata block
    head.write(0, 7)    # STREAMINFO
    head.write(34, 24)
    head.write(block_size, 16)
    head.write(block_size, 16)
    head.write(0, 24)
    head.write(0, 24)
    head.write(sample_rate, 20)
    head.write(channels - 1, 3)
    head.write(bps - 1, 5)
    head.write(frames, 36)
    for _ in range(16):
        head.write(0, 8)

    out = bytearray(head.bytes)
    for fi, start in enumerate(range(0, frames, block_size)):
        blk = samples[start : start + block_size]
        w = _BitWriter()
        w.write(0x3FFE, 14)  # sync
        w.write(0, 1)        # reserved
        w.write(0, 1)        # fixed blocksize stream
        w.write(7, 4)        # blocksize: 16-bit field
        w.write(0, 4)        # sample rate: STREAMINFO
        w.write(channels - 1, 4)
        w.write(0, 3)        # sample size: STREAMINFO
        w.write(0, 1)
        # coded frame number (UTF-8 style)
        if fi < 0x80:
            w.write(fi, 8)
        else:
            w.write(0xC0 | (fi >> 6), 8)
            w.write(0x80 | (fi & 0x3F), 8)
        w.write(len(blk) - 1, 16)
        w.write(_crc8(bytes(w.bytes)), 8)
        for c in range(channels):
            _subframe(w, blk[:, c], bps)
        w.align()
        w.write(_crc16(bytes(w.bytes)), 16)
        out += w.bytes
    Path(path).write_bytes(bytes(out))
