"""Common evaluation metrics (a copy of s3prl_tpu/metric/common.py:
accuracy, the edit-distance error rates, and speaker verification's EER
and minDCF on f64 scores).

Behavioral spec from the reference's metric module (s3prl/metric/common.py:
48-158). Edit distance is implemented here directly (numpy DP) instead of
binding the `editdistance` C package.
"""

from __future__ import annotations

from typing import Sequence, Tuple

import numpy as np


def accuracy(xs: Sequence, ys: Sequence, item_same_fn=None) -> float:
    same = [
        (item_same_fn(x, y) if item_same_fn else x == y) for x, y in zip(xs, ys)
    ]
    return float(np.mean([bool(s) for s in same])) if same else 0.0


def edit_distance(hyp: Sequence, ref: Sequence) -> int:
    """Levenshtein distance over arbitrary token sequences (numpy DP)."""
    m, n = len(hyp), len(ref)
    if m == 0:
        return n
    if n == 0:
        return m
    prev = np.arange(n + 1)
    cur = np.empty(n + 1, dtype=np.int64)
    for i in range(1, m + 1):
        cur[0] = i
        h = hyp[i - 1]
        for j in range(1, n + 1):
            cur[j] = min(
                prev[j] + 1,  # deletion
                cur[j - 1] + 1,  # insertion
                prev[j - 1] + (h != ref[j - 1]),  # substitution
            )
        prev, cur = cur, prev
    return int(prev[n])


def _er(hyps: Sequence[Sequence], refs: Sequence[Sequence]) -> float:
    """Corpus-level error rate: sum(dist) / sum(ref_len) (reference semantics)."""
    dist = sum(edit_distance(h, r) for h, r in zip(hyps, refs))
    total = sum(len(r) for r in refs)
    return dist / max(total, 1)


def ter(hyps: Sequence[Sequence], refs: Sequence[Sequence]) -> float:
    return _er(hyps, refs)


def wer(hyps: Sequence[str], refs: Sequence[str]) -> float:
    return _er([h.split() for h in hyps], [r.split() for r in refs])


def per(hyps: Sequence[str], refs: Sequence[str]) -> float:
    return wer(hyps, refs)


def cer(hyps: Sequence[str], refs: Sequence[str]) -> float:
    return _er([list(h) for h in hyps], [list(r) for r in refs])


def compute_eer(labels: Sequence[int], scores: Sequence[float]) -> Tuple[float, float]:
    """Equal error rate via ROC interpolation (reference: metric/common.py:107).

    Returns (eer, threshold).
    """
    labels = np.asarray(labels)
    scores = np.asarray(scores, dtype=np.float64)
    order = np.argsort(-scores)  # descending score
    labels = labels[order]
    scores = scores[order]
    P = max(int((labels == 1).sum()), 1)
    N = max(int((labels == 0).sum()), 1)
    tpr = np.cumsum(labels == 1) / P
    fpr = np.cumsum(labels == 0) / N
    fnr = 1.0 - tpr
    idx = int(np.nanargmin(np.abs(fnr - fpr)))
    eer = float((fnr[idx] + fpr[idx]) / 2.0)
    return eer, float(scores[idx])


def compute_minDCF(
    labels: Sequence[int],
    scores: Sequence[float],
    p_target: float = 0.01,
    c_miss: float = 1.0,
    c_fa: float = 1.0,
) -> Tuple[float, float]:
    """Minimum detection cost (reference: metric/common.py:124, NIST SRE)."""
    labels = np.asarray(labels)
    scores = np.asarray(scores, dtype=np.float64)
    order = np.argsort(scores)
    labels = labels[order]
    scores = scores[order]
    P = max(int((labels == 1).sum()), 1)
    N = max(int((labels == 0).sum()), 1)
    # threshold just below each score: miss = targets below, fa = nontargets >= thr
    miss = np.concatenate([[0], np.cumsum(labels == 1)]) / P
    fa = (N - np.concatenate([[0], np.cumsum(labels == 0)])) / N
    dcf = c_miss * miss * p_target + c_fa * fa * (1 - p_target)
    idx = int(np.argmin(dcf))
    c_def = min(c_miss * p_target, c_fa * (1 - p_target))
    thr = float(scores[min(idx, len(scores) - 1)]) if len(scores) else 0.0
    return float(dcf[idx] / c_def), thr
