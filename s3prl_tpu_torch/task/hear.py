"""HEAR 2021 tasks: scene prediction and timestamp (event) prediction (port
of s3prl_tpu/task/hear.py).

Behavioral spec from the reference (s3prl/task/scene_prediction.py,
event_prediction.py + nn/hear.py): a small MLP over pooled (scene) or
per-frame (event) featurized states; scene tasks use CE or multilabel BCE
with accuracy / mAP, event tasks use frame-level BCE with onset-based event
decoding (the reference defers scoring to hear-eval; here mAP and a simple
onset event-F1 are computed natively). The losses run on the states'
device in f32; the scores (mAP, aucroc, d_prime, the onset F1) are the JAX
package's host code in numpy and scipy.
"""

from __future__ import annotations

from typing import List

import numpy as np
import torch
import torch.nn.functional as F

from .base import Task, device_labels
from ..ops.masking import length_mask


def mean_average_precision(scores: np.ndarray, labels: np.ndarray) -> float:
    """scores/labels [N, C]; macro mAP over classes with any positives."""
    aps = []
    for c in range(scores.shape[1]):
        y, s = labels[:, c], scores[:, c]
        if y.sum() == 0:
            continue
        order = np.argsort(-s)
        y = y[order]
        cum = np.cumsum(y)
        precision = cum / (np.arange(len(y)) + 1)
        aps.append((precision * y).sum() / max(y.sum(), 1))
    return float(np.mean(aps)) if aps else 0.0


def roc_auc(scores: np.ndarray, labels: np.ndarray) -> float:
    """Macro ROC-AUC via the rank statistic (hear-eval's aucroc score)."""
    aucs = []
    for c in range(scores.shape[1]):
        y, s = labels[:, c], scores[:, c]
        pos, neg = int(y.sum()), int((1 - y).sum())
        if pos == 0 or neg == 0:
            continue
        order = np.argsort(s)
        ranks = np.empty(len(s))
        ranks[order] = np.arange(1, len(s) + 1)
        aucs.append((ranks[y > 0].sum() - pos * (pos + 1) / 2) / (pos * neg))
    return float(np.mean(aucs)) if aucs else 0.0


def d_prime(auc: float) -> float:
    """hear-eval d_prime: sqrt(2) * norminv(auc)."""
    from scipy.stats import norm

    return float(np.sqrt(2) * norm.ppf(np.clip(auc, 1e-7, 1 - 1e-7)))


def _bce_with_logits(logits: torch.Tensor, targets: torch.Tensor) -> torch.Tensor:
    """optax's sigmoid_binary_cross_entropy, elementwise."""
    return F.binary_cross_entropy_with_logits(logits, targets, reduction="none")


class ScenePredictionTask(Task):
    """Clip-level (multi)label prediction with the hear-eval score set
    (reference: s3prl/task/scene_prediction.py + hear-eval ScoreFunction):
    top1_acc, mAP, d_prime, aucroc, and nsynth's pitch/chroma accuracies
    (chroma folds predictions to pitch mod 12 via `class_values`)."""

    def __init__(self, module, num_classes: int, multilabel: bool = False,
                 scores=None, class_values=None):
        self.module = module
        self.num_classes = num_classes
        self.multilabel = multilabel
        self.scores = tuple(scores) if scores else (
            ("mAP", "top1_acc", "d_prime", "aucroc") if multilabel else ("top1_acc",)
        )
        self.class_values = None if class_values is None else np.asarray(class_values)
        self.host_keys = ("unique_name",)

    @property
    def valid_metric(self):
        return self.scores[0]

    valid_higher_better = True

    def loss_and_cache(self, hs, h_lens, batch, generator, train):
        logits = self._apply(hs, h_lens, generator, train).float()
        if self.multilabel:
            targets = torch.as_tensor(np.asarray(batch["multilabel"]),
                                      device=logits.device).float()
            loss = _bce_with_logits(logits, targets).mean()
            return loss, {"loss": loss.detach(), "scores": torch.sigmoid(logits).detach(),
                          "label": targets}
        labels = device_labels(batch, "class_id", logits.device)
        loss = F.cross_entropy(logits, labels)
        return loss, {"loss": loss.detach(), "scores": torch.softmax(logits, -1).detach(),
                      "label": labels}

    def reduction(self, mode, records):
        losses = [float(r["loss"]) for r in records]
        out = {"loss": float(np.mean(losses))}
        scores = np.concatenate([np.asarray(r["scores"]) for r in records])
        labels = np.concatenate([np.asarray(r["label"]) for r in records])
        if self.multilabel:
            onehot = labels
            class_ids = None
        else:
            class_ids = labels.astype(int)
            onehot = np.zeros_like(scores)
            onehot[np.arange(len(class_ids)), class_ids] = 1.0
        preds = scores.argmax(-1)
        for name in self.scores:
            if name == "mAP":
                out["mAP"] = mean_average_precision(scores, onehot)
            elif name in ("top1_acc", "accuracy", "pitch_acc"):
                out[name] = float((onehot[np.arange(len(preds)), preds] > 0).mean())
            elif name == "aucroc":
                out["aucroc"] = roc_auc(scores, onehot)
            elif name == "d_prime":
                out["d_prime"] = d_prime(roc_auc(scores, onehot))
            elif name == "chroma_acc" and class_ids is not None and self.class_values is not None:
                chroma = self.class_values % 12
                out["chroma_acc"] = float((chroma[preds] == chroma[class_ids]).mean())
        # keep "accuracy" for backward compatibility with existing recipes
        if not self.multilabel and "accuracy" not in out:
            out["accuracy"] = float((preds == class_ids).mean())
        return out


class EventPredictionTask(Task):
    """Frame-level multilabel activity -> onset-decoded events.

    The frame labels (10-ms frames) are cut to the states' frames (20 ms),
    as the JAX task does; the BCE runs over min(out_lens, T) frames.
    `onset_tolerance_ms` mirrors hear-eval's event_onset_*ms_fms scores
    (dcase: 200 ms, maestro: 50 ms)."""

    def __init__(self, module, num_classes: int, threshold: float = 0.5,
                 onset_tolerance_ms: float = 50.0, frame_shift_ms: float = 10.0,
                 score_name: str = "event_f1"):
        self.module = module
        self.num_classes = num_classes
        self.threshold = threshold
        self.tolerance_frames = max(int(round(onset_tolerance_ms / frame_shift_ms)), 1)
        self.score_name = score_name
        self.host_keys = ("unique_name",)

    @property
    def valid_metric(self):
        return self.score_name

    valid_higher_better = True

    def loss_and_cache(self, hs, h_lens, batch, generator, train):
        logits, out_lens = self._apply(hs, h_lens, generator, train)
        dev = logits.device
        frame_labels = torch.as_tensor(np.asarray(batch["frame_labels"]), device=dev)
        T = min(logits.shape[1], frame_labels.shape[1])
        targets = frame_labels[:, :T].float()
        logits = logits[:, :T].float()
        lens = torch.clamp(out_lens.to(dev), max=T)
        valid = length_mask(lens, T, torch.float32)[..., None]
        bce = _bce_with_logits(logits, targets)
        loss = (bce * valid).sum() / torch.clamp(valid.sum() * self.num_classes, min=1.0)
        return loss, {"loss": loss.detach(), "scores": torch.sigmoid(logits).detach(),
                      "label": targets, "lens": lens}

    def reduction(self, mode, records):
        tp = fp = fn = 0
        losses = []
        for r in records:
            losses.append(float(r["loss"]))
            scores, labels, lens = np.asarray(r["scores"]), np.asarray(r["label"]), np.asarray(r["lens"])
            for b in range(len(scores)):
                n = int(lens[b])
                pred_on = (scores[b, :n] > self.threshold).astype(int)
                ref_on = labels[b, :n].astype(int)
                for c in range(pred_on.shape[-1]):
                    pred_events = _onsets(pred_on[:, c])
                    ref_events = _onsets(ref_on[:, c])
                    matched = 0
                    used = set()
                    for p in pred_events:
                        for j, q in enumerate(ref_events):
                            if j not in used and abs(p - q) <= self.tolerance_frames:
                                matched += 1
                                used.add(j)
                                break
                    tp += matched
                    fp += len(pred_events) - matched
                    fn += len(ref_events) - matched
        precision = tp / max(tp + fp, 1)
        recall = tp / max(tp + fn, 1)
        f1 = 2 * precision * recall / max(precision + recall, 1e-9)
        return {"loss": float(np.mean(losses)), self.score_name: f1}


def _onsets(activity: np.ndarray) -> List[int]:
    starts = np.flatnonzero(np.diff(np.concatenate([[0], activity])) == 1)
    return starts.tolist()
