"""Diarization error components (a copy of s3prl_tpu/metric/diarization.py).

Behavioral spec from the reference's metric/diarization.py:18-57
(`calc_diarization_error`): frame-level comparison of multi-speaker activity
predictions vs labels over valid frames, returning the DER numerator pieces.
"""

from __future__ import annotations

from typing import Dict

import numpy as np


def calc_diarization_error(pred: np.ndarray, label: np.ndarray, length: int) -> Dict[str, float]:
    """pred/label: [T, num_spk] binary activity; length: valid frames.

    Returns the standard accumulators: speech/speaker counts, miss, falarm,
    confusion (speaker error), and correct frames.
    """
    pred = np.asarray(pred)[:length]
    label = np.asarray(label)[:length]
    n_ref = label.sum(axis=-1)  # speakers active in reference, per frame
    n_sys = pred.sum(axis=-1)
    res = {}
    res["speech_scored"] = float((n_ref > 0).sum())
    res["speech_miss"] = float(((n_ref > 0) & (n_sys == 0)).sum())
    res["speech_falarm"] = float(((n_ref == 0) & (n_sys > 0)).sum())
    res["speaker_scored"] = float(n_ref.sum())
    res["speaker_miss"] = float(np.maximum(n_ref - n_sys, 0).sum())
    res["speaker_falarm"] = float(np.maximum(n_sys - n_ref, 0).sum())
    n_map = ((label == 1) & (pred == 1)).sum(axis=-1)
    res["speaker_error"] = float((np.minimum(n_ref, n_sys) - n_map).sum())
    res["correct"] = float((label == pred).all(axis=-1).sum()) / max(length, 1)
    res["frames"] = float(length)
    return res


def der_from_accumulators(acc: Dict[str, float]) -> float:
    """DER = (miss + falarm + confusion) / scored speaker time."""
    denom = max(acc["speaker_scored"], 1.0)
    return (acc["speaker_miss"] + acc["speaker_falarm"] + acc["speaker_error"]) / denom
