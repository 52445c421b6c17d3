"""Feature dumping (port of s3prl_tpu/task/dump_feature.py; the reference's
s3prl/task/dump_feature.py): one layer of an upstream's states saved as one
``.npy`` [T, H] per utterance, e.g. the features of a second k-means round
of HuBERT pretraining."""

from __future__ import annotations

from pathlib import Path
from typing import List

import numpy as np


def dump_features(upstream, loader, out_dir, layer: int = -1) -> List[str]:
    """Runs `upstream` (frozen, on its device) over `loader`'s batches and
    writes layer `layer` of each utterance's valid frames to
    ``out_dir/<unique_name>.npy``; returns the paths written."""
    from ..train.trainer import _split_batch

    out_dir = Path(out_dir)
    out_dir.mkdir(parents=True, exist_ok=True)
    written = []
    for batch in loader:
        device, host = _split_batch(batch)
        hs, h_lens = upstream.apply_standardized(device["x"], device["x_len"])
        hs, h_lens = hs[layer].float().cpu().numpy(), h_lens.cpu().numpy()
        for b, name in enumerate(host.get("unique_name", range(len(h_lens)))):
            path = out_dir / f"{name}.npy"
            np.save(path, hs[b, : int(h_lens[b])])
            written.append(str(path))
    return written
