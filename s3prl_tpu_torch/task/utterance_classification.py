"""Utterance classification tasks (port of s3prl_tpu/task/
utterance_classification.py; the reference's UtteranceClassificationTask,
s3prl/task/utterance_classification_task.py:62-227): cross-entropy over a
pooled utterance embedding, accuracy reduction, per-utterance prediction
records. The multi-class variant (IC) sums CE over several label heads;
the frame variant averages per-frame CE over valid, labelled frames.
The logits are f32 (the heads' `Dense` layers compute in f32); the
reductions are the JAX package's host code.
"""

from __future__ import annotations

from typing import Any, Dict, List, Tuple

import numpy as np
import torch
import torch.nn.functional as F

from .base import Task, device_labels
from ..metric import accuracy


class UtteranceClassificationTask(Task):
    def __init__(self, module, num_classes: int):
        self.module = module
        self.num_classes = num_classes
        self.host_keys = ("unique_name",)

    valid_metric = "accuracy"
    valid_higher_better = True

    def loss_and_cache(self, hs, h_lens, batch, generator, train):
        logits = self._apply(hs, h_lens, generator, train)
        labels = device_labels(batch, "class_id", logits.device)
        loss = F.cross_entropy(logits.float(), labels)
        pred = torch.argmax(logits, dim=-1)
        return loss, {"loss": loss.detach(), "prediction": pred, "label": labels}

    def reduction(self, mode: str, records: List[Dict[str, Any]]) -> Dict[str, float]:
        preds = np.concatenate([r["prediction"] for r in records])
        labels = np.concatenate([r["label"] for r in records])
        losses = [float(r["loss"]) for r in records]
        return {"accuracy": accuracy(preds.tolist(), labels.tolist()), "loss": float(np.mean(losses))}


class UtteranceMultiClassClassificationTask(Task):
    """Several independent category heads (SUPERB IC: action/object/location).

    Reference: task/utterance_classification_task.py (MultiClass variant) —
    the module emits one concatenated logit vector; it is split per head and
    CE summed; an utterance counts as correct when every head is correct.
    """

    def __init__(self, module, class_sizes: Tuple[int, ...]):
        self.module = module
        self.class_sizes = tuple(class_sizes)
        self.host_keys = ("unique_name",)

    valid_metric = "accuracy"
    valid_higher_better = True

    def loss_and_cache(self, hs, h_lens, batch, generator, train):
        logits = self._apply(hs, h_lens, generator, train)
        labels = device_labels(batch, "class_ids", logits.device)  # [B, num_heads]
        start = 0
        loss = 0.0
        preds = []
        for i, size in enumerate(self.class_sizes):
            head = logits[:, start : start + size]
            loss = loss + F.cross_entropy(head.float(), labels[:, i])
            preds.append(torch.argmax(head, dim=-1))
            start += size
        pred = torch.stack(preds, dim=-1)  # [B, num_heads]
        return loss, {"loss": loss.detach(), "prediction": pred, "label": labels}

    def reduction(self, mode: str, records: List[Dict[str, Any]]) -> Dict[str, float]:
        preds = np.concatenate([r["prediction"] for r in records])
        labels = np.concatenate([r["label"] for r in records])
        correct = (preds == labels).all(axis=-1)
        losses = [float(r["loss"]) for r in records]
        return {"accuracy": float(correct.mean()), "loss": float(np.mean(losses))}


class FrameClassificationTask(Task):
    """Frame-level classification probe (reference: downstream/phone_linear/
    expert.py:123-165 and the speaker/voxceleb1_framelevel variants):
    per-frame CE over aligned frame labels; features and labels are matched
    by truncation to the shorter sequence (reference _match_length), frames
    with label < 0 (padding) are masked; accuracy is frame-weighted.

    Batches carry either 'frame_labels' [B, T_lab] (padded with -100) or a
    per-utterance 'class_id' broadcast over the valid frames."""

    def __init__(self, module, num_classes: int):
        self.module = module
        self.num_classes = num_classes
        self.host_keys = ("unique_name",)

    valid_metric = "accuracy"
    valid_higher_better = True

    def loss_and_cache(self, hs, h_lens, batch, generator, train):
        out = self._apply(hs, h_lens, generator, train)
        logits, out_lens = out if isinstance(out, tuple) else (out, h_lens)
        B, T = logits.shape[:2]
        dev = logits.device
        frame_valid = torch.arange(T, device=dev)[None, :] < out_lens.to(dev)[:, None]
        if "frame_labels" in batch:
            labels = device_labels(batch, "frame_labels", dev)
            Tm = min(T, labels.shape[1])
            logits = logits[:, :Tm]
            labels = labels[:, :Tm]
            valid = frame_valid[:, :Tm] & (labels >= 0)
        else:
            labels = device_labels(batch, "class_id", dev)[:, None].expand(B, T)
            valid = frame_valid
        safe_labels = torch.clamp(labels, min=0)
        ce = F.cross_entropy(logits.float().transpose(1, 2), safe_labels, reduction="none")
        denom = torch.clamp(valid.sum(), min=1)
        loss = torch.where(valid, ce, 0.0).sum() / denom
        pred = torch.argmax(logits, dim=-1)
        correct = valid & (pred == safe_labels)
        return loss, {
            "loss": loss.detach(),
            "n_correct": correct.sum(),
            "n_frames": valid.sum(),
        }

    def reduction(self, mode: str, records: List[Dict[str, Any]]) -> Dict[str, float]:
        n_correct = float(np.sum([float(r["n_correct"]) for r in records]))
        n_frames = float(np.sum([float(r["n_frames"]) for r in records]))
        losses = [float(r["loss"]) for r in records]
        return {"accuracy": n_correct / max(n_frames, 1.0),
                "loss": float(np.mean(losses))}
