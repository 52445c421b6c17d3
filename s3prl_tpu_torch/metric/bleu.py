"""Corpus BLEU (a copy of s3prl_tpu/metric/bleu.py: sacrebleu-compatible
BLEU-4 with exp smoothing off).

The reference scores speech translation with sacrebleu
(s3prl/downstream/speech_translation). This is a dependency-free corpus
BLEU: modified n-gram precision up to 4, geometric mean, brevity penalty.
"""

from __future__ import annotations

import math
from collections import Counter
from typing import List


def _ngrams(tokens: List[str], n: int) -> Counter:
    return Counter(tuple(tokens[i : i + n]) for i in range(len(tokens) - n + 1))


def corpus_bleu(hyps: List[str], refs: List[str], max_n: int = 4) -> float:
    matches = [0] * max_n
    totals = [0] * max_n
    hyp_len = ref_len = 0
    for hyp, ref in zip(hyps, refs):
        h, r = hyp.split(), ref.split()
        hyp_len += len(h)
        ref_len += len(r)
        for n in range(1, max_n + 1):
            hc, rc = _ngrams(h, n), _ngrams(r, n)
            overlap = sum(min(c, rc[g]) for g, c in hc.items())
            matches[n - 1] += overlap
            totals[n - 1] += max(len(h) - n + 1, 0)
    if min(totals) == 0 or min(matches) == 0:
        return 0.0
    log_prec = sum(math.log(m / t) for m, t in zip(matches, totals)) / max_n
    bp = 1.0 if hyp_len > ref_len else math.exp(1 - ref_len / max(hyp_len, 1))
    return 100.0 * bp * math.exp(log_prec)
