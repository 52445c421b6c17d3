"""Classification metrics (port of s3prl_tpu/metric/common.py:20-24, copied:
the port imports nothing of the JAX package). The reference's metric
module: s3prl/metric/common.py:48-158."""

from __future__ import annotations

from typing import Sequence

import numpy as np


def accuracy(xs: Sequence, ys: Sequence, item_same_fn=None) -> float:
    same = [
        (item_same_fn(x, y) if item_same_fn else x == y) for x, y in zip(xs, ys)
    ]
    return float(np.mean([bool(s) for s in same])) if same else 0.0
