"""Speaker diarization task, SUPERB SD (port of s3prl_tpu/task/
diarization.py).

Behavioral spec from the reference's DiarizationPIT task
(s3prl/task/diarization.py:25-160): frame-level multi-speaker activity
prediction trained with permutation-invariant BCE (every speaker
permutation's masked mean BCE, the minimum a row), DER accumulation in the
reduction and, in test mode, a hypothesis RTTM (host numpy, the JAX
package's code).

The labels are cut to the states' frames (the JAX task's rule: its label
grid is 160 samples, the trunks' 320) and masked by min(states' lengths,
label lengths). The states' lengths go to the host once a step: the packed
LSTM takes them there.
"""

from __future__ import annotations

import itertools
from pathlib import Path
from typing import Any, Dict, List

import numpy as np
import torch
import torch.nn.functional as F

from .base import Task
from ..metric.diarization import calc_diarization_error
from ..ops.masking import length_mask


class DiarizationPITTask(Task):
    def __init__(self, module, num_speakers: int = 2, frame_shift_sec: float = 0.02,
                 rttm_dir=None):
        self.module = module  # (hs, h_lens) -> (logits [B, T, S], lens)
        self.num_speakers = num_speakers
        self.perms = list(itertools.permutations(range(num_speakers)))
        self.frame_shift_sec = frame_shift_sec
        # when set, test-mode reduction dumps hypothesis RTTMs here
        # (reference: s3prl/task/diarization.py writes RTTM at inference)
        self.rttm_dir = rttm_dir
        self.host_keys = ("unique_name",)

    valid_metric = "der"
    valid_higher_better = False

    def loss_and_cache(self, hs, h_lens, batch, generator, train):
        lens = h_lens.cpu()  # the step's one host sync
        logits, out_lens = self._apply(hs, lens, generator, train)
        B, T, S = logits.shape
        dev = logits.device
        labels = torch.as_tensor(batch["label"], device=dev)[:, :T].float()
        label_len = torch.as_tensor(batch["label_len"]).cpu()
        pred_len = torch.minimum(out_lens.cpu(), label_len.to(out_lens.dtype))
        mask = length_mask(pred_len.to(dev), T, torch.float32)
        denom = torch.clamp(mask.sum(-1), min=1.0)
        losses = torch.stack([
            (F.binary_cross_entropy_with_logits(logits, labels[..., list(perm)], reduction="none")
             .mean(-1) * mask).sum(-1) / denom
            for perm in self.perms])  # [P, B]
        best = torch.argmin(losses, dim=0)
        loss = torch.min(losses, dim=0).values.mean()
        pred = (torch.sigmoid(logits) > 0.5).to(torch.int32)
        return loss, {
            "loss": loss.detach(),
            "prediction": pred,
            "prediction_len": pred_len,
            "label": labels,
            "best_perm": best,
        }

    def reduction(self, mode: str, records: List[Dict[str, Any]]) -> Dict[str, float]:
        acc: Dict[str, float] = {}
        losses = []
        for r in records:
            losses.append(float(r["loss"]))
            preds, labels, lens, best = (
                np.asarray(r["prediction"]),
                np.asarray(r["label"]),
                np.asarray(r["prediction_len"]),
                np.asarray(r["best_perm"]),
            )
            for b in range(len(preds)):
                perm = self.perms[int(best[b])]
                stats = calc_diarization_error(
                    preds[b], labels[b][..., list(perm)], int(lens[b])
                )
                for k, v in stats.items():
                    acc[k] = acc.get(k, 0.0) + v
        denom = max(acc.get("speaker_scored", 0.0), 1.0)
        der = (
            acc.get("speaker_miss", 0.0)
            + acc.get("speaker_falarm", 0.0)
            + acc.get("speaker_error", 0.0)
        ) / denom
        if mode == "test" and self.rttm_dir is not None:
            self._dump_rttm(records)
        return {"der": der, "loss": float(np.mean(losses))}

    def _dump_rttm(self, records) -> None:
        """Hypothesis RTTMs from thresholded activities (one file per batch
        record set, standard `SPEAKER <utt> 1 <start> <dur> ...` lines)."""
        out_dir = Path(self.rttm_dir)
        out_dir.mkdir(parents=True, exist_ok=True)
        shift = self.frame_shift_sec
        with open(out_dir / "hyp.rttm", "w") as f:
            for r in records:
                preds = np.asarray(r["prediction"])
                lens = np.asarray(r["prediction_len"])
                names = r.get("unique_name", [f"utt{i}" for i in range(len(preds))])
                for b in range(len(preds)):
                    name = str(names[b])
                    n = int(lens[b])
                    for s in range(preds.shape[-1]):
                        act = np.concatenate([[0], preds[b, :n, s], [0]])
                        starts = np.flatnonzero(np.diff(act) == 1)
                        ends = np.flatnonzero(np.diff(act) == -1)
                        for st, en in zip(starts, ends):
                            f.write(
                                f"SPEAKER {name} 1 {st * shift:.3f} "
                                f"{(en - st) * shift:.3f} <NA> <NA> spk{s} <NA> <NA>\n"
                            )
