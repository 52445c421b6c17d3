"""A reader of the msgpack files ``flax.serialization.to_bytes`` writes, the
JAX package's checkpoints (``params.msgpack``), in pure Python: the port
needs no ``msgpack`` package.

It reads what flax writes of a parameter tree and nothing more: maps, arrays,
str, bin, int, float, bool, nil and extension type 1 (an ndarray as the
msgpack triple (shape, dtype name, C-order bytes); bfloat16 comes back as
``torch.bfloat16``), and flax's chunked arrays (``__msgpack_chunked_array__``,
above 2 GiB). Anything else raises ValueError.
"""

from __future__ import annotations

import struct
from typing import Any, Tuple

import numpy as np
import torch

_NDARRAY_EXT = 1


class _Reader:
    def __init__(self, data: bytes):
        self.data = memoryview(data)
        self.pos = 0

    def take(self, n: int) -> memoryview:
        if self.pos + n > len(self.data):
            raise ValueError("msgpack: truncated data")
        out = self.data[self.pos:self.pos + n]
        self.pos += n
        return out

    def unpack(self, fmt: str):
        return struct.unpack(fmt, self.take(struct.calcsize(fmt)))[0]

    def value(self) -> Any:
        b = self.unpack(">B")
        if b <= 0x7F:
            return b
        if b >= 0xE0:
            return b - 0x100
        if 0x80 <= b <= 0x8F:
            return self.map(b & 0x0F)
        if 0x90 <= b <= 0x9F:
            return self.array(b & 0x0F)
        if 0xA0 <= b <= 0xBF:
            return str(self.take(b & 0x1F), "utf-8")
        simple = {0xC0: None, 0xC2: False, 0xC3: True}
        if b in simple:
            return simple[b]
        sized = {0xC4: ("bin", ">B"), 0xC5: ("bin", ">H"), 0xC6: ("bin", ">I"),
                 0xD9: ("str", ">B"), 0xDA: ("str", ">H"), 0xDB: ("str", ">I"),
                 0xDC: ("array", ">H"), 0xDD: ("array", ">I"),
                 0xDE: ("map", ">H"), 0xDF: ("map", ">I"),
                 0xC7: ("ext", ">B"), 0xC8: ("ext", ">H"), 0xC9: ("ext", ">I")}
        if b in sized:
            kind, fmt = sized[b]
            n = self.unpack(fmt)
            if kind == "bin":
                return bytes(self.take(n))
            if kind == "str":
                return str(self.take(n), "utf-8")
            if kind == "array":
                return self.array(n)
            if kind == "map":
                return self.map(n)
            return self.ext(self.unpack(">b"), n)
        numbers = {0xCA: ">f", 0xCB: ">d", 0xCC: ">B", 0xCD: ">H", 0xCE: ">I", 0xCF: ">Q",
                   0xD0: ">b", 0xD1: ">h", 0xD2: ">i", 0xD3: ">q"}
        if b in numbers:
            return self.unpack(numbers[b])
        fixext = {0xD4: 1, 0xD5: 2, 0xD6: 4, 0xD7: 8, 0xD8: 16}
        if b in fixext:
            return self.ext(self.unpack(">b"), fixext[b])
        raise ValueError(f"msgpack: type byte 0x{b:02x} is not one flax writes")

    def array(self, n: int) -> list:
        return [self.value() for _ in range(n)]

    def map(self, n: int) -> dict:
        out = {}
        for _ in range(n):
            key = self.value()
            out[key] = self.value()
        return out

    def ext(self, code: int, n: int) -> torch.Tensor:
        if code != _NDARRAY_EXT:
            raise ValueError(f"msgpack: extension type {code}; flax's ndarray is type 1")
        payload = bytes(self.take(n))
        shape, dtype, buf = _Reader(payload).value()
        return _tensor(tuple(shape), dtype, buf)


def _tensor(shape: Tuple[int, ...], dtype: str, buf: bytes) -> torch.Tensor:
    if dtype == "bfloat16":
        raw = np.frombuffer(buf, dtype=np.uint16).reshape(shape)
        return torch.from_numpy(raw.copy()).view(torch.bfloat16)
    return torch.from_numpy(np.frombuffer(buf, dtype=np.dtype(dtype)).reshape(shape).copy())


def _unchunk(tree: Any) -> Any:
    """flax's chunked arrays (``_chunk``: {"__msgpack_chunked_array__",
    "shape": {"0": ...}, "chunks": {"0": ...}}) back into one tensor."""
    if not isinstance(tree, dict):
        return tree
    if tree.get("__msgpack_chunked_array__"):
        shape = [tree["shape"][str(i)] for i in range(len(tree["shape"]))]
        chunks = [tree["chunks"][str(i)] for i in range(len(tree["chunks"]))]
        return torch.cat([c.reshape(-1) for c in chunks]).reshape(shape)
    return {k: _unchunk(v) for k, v in tree.items()}


def msgpack_restore(data: bytes) -> Any:
    """The tree ``flax.serialization.msgpack_restore`` returns, with torch
    tensors for its arrays."""
    reader = _Reader(data)
    tree = reader.value()
    if reader.pos != len(reader.data):
        raise ValueError("msgpack: trailing bytes after the tree")
    return _unchunk(tree)
