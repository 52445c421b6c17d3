"""DistilHuBERT pretraining: multi-layer teacher distillation (port of
s3prl_tpu/task/distiller_pretrain.py; the reference's pretrain/distiller/
pretrain_expert.py:242-375).

The frozen teacher is the Trainer's upstream (HuBERT by default): its
hidden states arrive as `hs`, under ``no_grad``. The student
`DistillerModel` emits one prediction per ``pred_layer_id`` teacher layer;
the loss is L1 (or L2) to those layers plus ``cosine_loss`` times
``-logsigmoid(cos)``, the cosine's denominator floored at 1e-8.
"""

from __future__ import annotations

from typing import Any, Dict, List, Sequence

import numpy as np
import torch
import torch.nn.functional as F

from .base import Task
from .hubert_pretrain import device_wavs, init_trunk
from ..ops.masking import length_mask


class DistillerPretrainTask(Task):
    """module: `DistillerModel` — (wavs, wav_lens, generator) ->
    (hidden_states [1 + L + n_tasks, B, T, D], feat_lens)."""

    def __init__(self, module, n_tasks: int, pred_layer_id: Sequence[int],
                 loss_type: str = "l1", cosine_loss: float = 1.0):
        assert len(pred_layer_id) == n_tasks
        self.module = module
        self.n_tasks = n_tasks
        self.pred_layer_id = tuple(pred_layer_id)
        self.loss_type = loss_type
        self.cosine_loss = cosine_loss
        self.host_keys = ()

    valid_metric = "loss"
    valid_higher_better = False

    def init_params(self, generator=None) -> None:
        """The student as the registry's ``distilhubert`` (flax's
        initialisers)."""
        init_trunk(self.module, generator)

    def loss_and_cache(self, hs, h_lens, batch, generator, train):
        wavs, wav_lens = device_wavs(batch, hs.device)
        if self.module.training != train:
            self.module.train(train)
        student_hs, s_lens = self.module(wavs, wav_lens, generator if train else None)
        preds = student_hs[-self.n_tasks:]
        targets = torch.stack([hs[i] for i in self.pred_layer_id])
        T = min(preds.shape[2], targets.shape[2])
        preds = preds[:, :, :T].float()
        targets = targets[:, :, :T].float()
        valid = length_mask(torch.minimum(s_lens, h_lens.to(s_lens.device)), T)[None, :, :, None]
        diff = preds - targets
        err = diff.abs() if self.loss_type == "l1" else diff ** 2
        denom = torch.clamp(valid.sum(), min=1) * preds.shape[0] * preds.shape[-1]
        rec_loss = torch.where(valid, err, 0.0).sum() / denom
        loss, sim_loss = rec_loss, torch.zeros((), device=preds.device)
        if self.cosine_loss > 0:
            cos = (preds * targets).sum(-1) * torch.rsqrt(torch.clamp(
                (preds ** 2).sum(-1) * (targets ** 2).sum(-1), min=1e-8))
            sim = -F.logsigmoid(cos)[..., None]
            sim_loss = torch.where(valid, sim, 0.0).sum() / denom * preds.shape[-1]
            loss = loss + self.cosine_loss * sim_loss
        return loss, {"loss": loss.detach(), "rec_loss": rec_loss.detach(),
                      "sim_loss": sim_loss.detach()}

    def reduction(self, mode: str, records: List[Dict[str, Any]]) -> Dict[str, float]:
        return {k: float(np.mean([float(r[k]) for r in records]))
                for k in ("loss", "rec_loss", "sim_loss")}
