"""CTC speech-to-text tasks, SUPERB ASR / PR / SF (port of
s3prl_tpu/task/speech2text_ctc.py).

Behavioral spec from the reference's Speech2TextCTCTask
(s3prl/task/speech2text_ctc_task.py:107-137): CTC loss with blank == pad
id, greedy decode = per-frame argmax -> unique-consecutive -> drop blanks,
WER/CER reduction. The loss is the JAX package's ``optax.ctc_loss`` per
sequence (`ops.ctc.ctc_loss`: ``F.ctc_loss`` for the rows it can score, the
plain copy of optax's recursion for the others), so an infeasible row costs
about 1e5, as in JAX, and never the reference's ``zero_infinity`` 0; the
``isfinite`` guard is kept as the JAX task has it. The reductions are the
JAX package's host code.

The states' lengths go to the host once a step (`loss_and_cache`): the
packed LSTM and the CTC loss take them there, and the split of rows
between the two CTC routes reads them.
"""

from __future__ import annotations

from typing import Any, Dict, List

import numpy as np
import torch

from .base import Task
from ..metric import cer, per, wer
from ..metric.slot_filling import slot_type_f1, slot_value_cer, slot_value_wer
from ..ops.ctc import ctc_loss


class Speech2TextCTCTask(Task):
    def __init__(self, module, tokenizer, metric: str = "wer"):
        self.module = module
        self.tokenizer = tokenizer
        self.metric = metric  # "wer" (ASR) | "per" (PR) | slot metrics via SF
        self.host_keys = ("labels", "unique_name")

    @property
    def valid_metric(self):
        return self.metric

    valid_higher_better = False

    def loss_and_cache(self, hs, h_lens, batch, generator, train):
        lens = h_lens.cpu()  # the step's one host sync
        logits, out_lens = self._apply(hs, lens, generator, train)
        token_lens = np.asarray(batch["class_ids_len"])
        per_seq = ctc_loss(logits, out_lens, np.asarray(batch["class_ids"]), token_lens,
                           blank_id=self.tokenizer.pad_idx)
        per_seq = torch.where(torch.isfinite(per_seq), per_seq, 0.0)
        loss = per_seq.sum() / max(int((token_lens > 0).sum()), 1)
        pred = torch.argmax(logits, dim=-1)  # [B, T]
        return loss, {"loss": loss.detach(), "prediction": pred, "prediction_len": out_lens}

    def _decode(self, ids: np.ndarray, length: int) -> str:
        return self.tokenizer.decode(ids[:length].tolist(), ignore_repeat=True)

    def _hypotheses(self, records: List[Dict[str, Any]]):
        hyps, refs, losses = [], [], []
        for r in records:
            preds, lens = r["prediction"], r["prediction_len"]
            for b in range(len(preds)):
                hyps.append(self._decode(np.asarray(preds[b]), int(lens[b])))
            refs.extend(r["labels"])
            losses.append(float(r["loss"]))
        return hyps, refs, losses

    def reduction(self, mode: str, records: List[Dict[str, Any]]) -> Dict[str, float]:
        hyps, refs, losses = self._hypotheses(records)
        out = {
            "loss": float(np.mean(losses)),
            "wer": wer(hyps, refs),
            "cer": cer(hyps, refs),
        }
        if self.metric == "per":
            out["per"] = per(hyps, refs)
        return out


class SlotFillingCTCTask(Speech2TextCTCTask):
    """SF variant: adds slot-type F1 / slot-value CER+WER to the reduction
    (reference: task/speech2text_ctc_task.py used with the slot tokenizer +
    metric/slot_filling.py)."""

    def __init__(self, module, tokenizer):
        super().__init__(module, tokenizer, metric="slot_type_f1")

    valid_higher_better = True

    def reduction(self, mode, records):
        hyps, refs, losses = self._hypotheses(records)
        return {
            "loss": float(np.mean(losses)),
            "slot_type_f1": slot_type_f1(hyps, refs),
            "slot_value_cer": slot_value_cer(hyps, refs),
            "slot_value_wer": slot_value_wer(hyps, refs),
        }
