"""Slot-filling metrics (SUPERB SF) (a copy of s3prl_tpu/metric/slot_filling.py).

Behavioral spec from the reference's metric/slot_filling.py: slot-type F1 and
slot-value CER/WER computed from transcripts where slot regions are wrapped
in B-<type> ... E-<type> style markers, plus full/part edit-F1 variants.
"""

from __future__ import annotations

import re
from typing import List, Tuple

from .common import cer, wer


def _parse_slots(text: str) -> List[Tuple[str, str]]:
    """Extract (slot_type, value) pairs from 'B-type value E-type' markup."""
    slots = []
    pattern = re.compile(r"B-([\w.]+)\s+(.*?)\s+E-\1")
    for m in pattern.finditer(text):
        slots.append((m.group(1), m.group(2).strip()))
    return slots


def slot_type_f1(hyps: List[str], refs: List[str]) -> float:
    tp = fp = fn = 0
    for hyp, ref in zip(hyps, refs):
        hyp_types = [t for t, _ in _parse_slots(hyp)]
        ref_types = [t for t, _ in _parse_slots(ref)]
        for t in list(hyp_types):
            if t in ref_types:
                tp += 1
                ref_types.remove(t)
            else:
                fp += 1
        fn += len(ref_types)
    precision = tp / max(tp + fp, 1)
    recall = tp / max(tp + fn, 1)
    return 2 * precision * recall / max(precision + recall, 1e-9)


def slot_value_cer(hyps: List[str], refs: List[str]) -> float:
    hyp_vals, ref_vals = [], []
    for hyp, ref in zip(hyps, refs):
        hyp_vals.append(" ".join(v for _, v in _parse_slots(hyp)))
        ref_vals.append(" ".join(v for _, v in _parse_slots(ref)))
    return cer(hyp_vals, ref_vals)


def slot_value_wer(hyps: List[str], refs: List[str]) -> float:
    hyp_vals, ref_vals = [], []
    for hyp, ref in zip(hyps, refs):
        hyp_vals.append(" ".join(v for _, v in _parse_slots(hyp)))
        ref_vals.append(" ".join(v for _, v in _parse_slots(ref)))
    return wer(hyp_vals, ref_vals)


def slot_edit_f1_full(hyps: List[str], refs: List[str]) -> float:
    return _slot_edit_f1(hyps, refs, part=False)


def slot_edit_f1_part(hyps: List[str], refs: List[str]) -> float:
    return _slot_edit_f1(hyps, refs, part=True)


def _slot_edit_f1(hyps: List[str], refs: List[str], part: bool) -> float:
    tp = fp = fn = 0
    for hyp, ref in zip(hyps, refs):
        hyp_slots = _parse_slots(hyp)
        ref_slots = _parse_slots(ref)
        for slot in list(hyp_slots):
            matched = None
            for r in ref_slots:
                if r[0] != slot[0]:
                    continue
                if (not part and r[1] == slot[1]) or (part and (r[1] in slot[1] or slot[1] in r[1])):
                    matched = r
                    break
            if matched is not None:
                tp += 1
                ref_slots.remove(matched)
            else:
                fp += 1
        fn += len(ref_slots)
    precision = tp / max(tp + fp, 1)
    recall = tp / max(tp + fn, 1)
    return 2 * precision * recall / max(precision + recall, 1e-9)
