"""Collation to bucketed static-shape padded arrays (a copy of s3prl_tpu/data/collate.py).

The XLA-facing edge of the data layer: the reference pads each batch to its
own max length (dataio/collate_fn.py); under jit that would compile one
program per length, so here every batch is padded up to a *bucket* boundary
— a small fixed set of lengths — giving a bounded, warm jit cache. This is
the TPU rendering of the reference's bucketing strategy (SURVEY §5.7).
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Dict, List, Optional, Sequence

import numpy as np


@dataclass(frozen=True)
class Buckets:
    """A monotone set of allowed padded lengths."""

    boundaries: tuple

    @classmethod
    def geometric(cls, min_len: int, max_len: int, factor: float = 1.3) -> "Buckets":
        out = [min_len]
        while out[-1] < max_len:
            out.append(int(out[-1] * factor))
        return cls(tuple(out))

    @classmethod
    def linear(cls, step: int, max_len: int) -> "Buckets":
        return cls(tuple(range(step, max_len + step, step)))

    def fit(self, length: int) -> int:
        for b in self.boundaries:
            if length <= b:
                return b
        return self.boundaries[-1]


DEFAULT_WAV_BUCKETS = Buckets.linear(16000, 16000 * 30)  # 1 s steps up to 30 s

#: the label keys padded with another value than 0 (a loss masks them by
#: value): the frame probes' collate, and the trainer's gather of the dp
#: ranks' batches
PAD_VALUES = {"frame_labels": -100}


def pad_stack(
    arrays: Sequence[np.ndarray], target_len: Optional[int] = None, pad_value=0
) -> np.ndarray:
    """Stack variable-length arrays [Ti, ...] -> [B, T, ...] with padding."""
    maxlen = max(a.shape[0] for a in arrays)
    T = target_len or maxlen
    assert T >= maxlen, (T, maxlen)
    out = np.full((len(arrays), T) + arrays[0].shape[1:], pad_value, dtype=arrays[0].dtype)
    for i, a in enumerate(arrays):
        out[i, : a.shape[0]] = a
    return out


def pad_collate(
    items: List[dict],
    buckets: Optional[Buckets] = None,
    pad_keys: Dict[str, int] = None,
) -> dict:
    """Collate dicts of numpy arrays / scalars / strings into a batch dict.

    - 1-D+ float/int arrays are padded (key 'x' additionally gets 'x_len');
      if `buckets` is given, the wav key 'x' pads up to a bucket boundary.
    - scalars stack; strings stay as lists (reference: dataio/collate_fn.py).
    """
    assert items
    out: dict = {}
    pad_keys = pad_keys or {}
    for key in items[0]:
        vals = [it[key] for it in items]
        first = vals[0]
        if isinstance(first, np.ndarray) and first.ndim >= 1:
            lens = np.asarray([v.shape[0] for v in vals], np.int32)
            target = None
            if key == "x" and buckets is not None:
                target = buckets.fit(int(lens.max()))
            out[key] = pad_stack(vals, target, pad_keys.get(key, 0))
            out[f"{key}_len"] = lens
        elif isinstance(first, (int, np.integer)):
            out[key] = np.asarray(vals, np.int32)
        elif isinstance(first, (float, np.floating)):
            out[key] = np.asarray(vals, np.float32)
        else:
            out[key] = vals
    return out
