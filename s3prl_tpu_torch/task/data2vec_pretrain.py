"""data2vec audio pretraining: masked regression onto an EMA teacher (port of
s3prl_tpu/task/data2vec_pretrain.py; the reference's data2vec_model.py:
428-600).

The student trunk sees span-masked features; the teacher, an exponential
moving average of the student, sees the clean waves, and its top-K layer
outputs, each instance-normalised over the padded time axis, averaged, are
the target of an L2 loss on the masked frames. The teacher runs in
``eval()`` under ``torch.no_grad()``: on the card its layer-norm extractor
takes K3 `conv0_ln_gelu` (erf) every step, on the weights the last
`post_update` moved (the trunk derives nothing from its weights at load
without ``quantize`` or an option, and the teacher takes neither).
`post_update` (the Trainer runs it under ``no_grad`` after every micro-step)
moves the teacher: ``t = d t + (1 - d) s``.
"""

from __future__ import annotations

import copy
from typing import Any, Dict, List

import numpy as np
import torch
import torch.nn as nn

from .base import Task
from .hubert_pretrain import device_wavs, init_trunk
from ..ops.masking import compute_mask_indices, length_mask


class StudentTeacher(nn.Module):
    """``student`` (a `Wav2Vec2Trunk`) and ``teacher`` (its copy, the JAX
    tree's ``{"student", "teacher"}``); the teacher stays in ``eval()``."""

    def __init__(self, student: nn.Module):
        super().__init__()
        self.student = student
        self.teacher = copy.deepcopy(student).eval()

    def train(self, mode: bool = True):
        self.training = mode
        self.student.train(mode)
        self.teacher.eval()
        return self


class Data2VecPretrainTask(Task):
    """module: a trunk taking (wavs, wav_lens, generator=, mask_indices=)
    -> (hidden_states [L+1, B, T, C], lens), held with its EMA copy as a
    `StudentTeacher`."""

    def __init__(self, module: nn.Module, average_top_k_layers: int = 8,
                 ema_decay: float = 0.999, mask_prob: float = 0.65, mask_length: int = 10,
                 instance_norm_targets: bool = True):
        self.module = StudentTeacher(module)
        self.k = average_top_k_layers
        self.ema_decay = ema_decay
        self.mask_prob = mask_prob
        self.mask_length = mask_length
        self.instance_norm_targets = instance_norm_targets
        self.host_keys = ()

    valid_metric = "loss"
    valid_higher_better = False

    @torch.no_grad()
    def init_params(self, generator=None) -> None:
        """The student as the registry's trunks, the teacher its copy."""
        init_trunk(self.module.student, generator)
        self.module.teacher.load_state_dict(self.module.student.state_dict())

    @torch.no_grad()
    def post_update(self) -> None:
        """The EMA of every teacher parameter toward the student's."""
        d = self.ema_decay
        for t, s in zip(self.module.teacher.parameters(), self.module.student.parameters()):
            t.copy_(d * t + (1.0 - d) * s)

    @torch.no_grad()
    def targets(self, wavs, wav_lens):
        """The teacher's regression targets [B, T, C] and its lengths."""
        hs, lens = self.module.teacher(wavs, wav_lens)
        top = hs[-self.k:].float()  # [K, B, T, C]
        if self.instance_norm_targets:
            mean = top.mean(dim=2, keepdim=True)
            var = top.var(dim=2, unbiased=False, keepdim=True)
            top = (top - mean) * torch.rsqrt(var + 1e-5)
        return top.mean(dim=0), lens

    def loss_and_cache(self, hs, h_lens, batch, generator, train):
        wavs, wav_lens = device_wavs(batch, hs.device)
        if self.module.training != train:
            self.module.train(train)
        targets, t_lens = self.targets(wavs, wav_lens)
        B, T, _ = targets.shape
        valid = length_mask(t_lens, T)
        mask = compute_mask_indices(generator, (B, T), ~valid, self.mask_prob,
                                    self.mask_length, device=hs.device)
        student_hs, _ = self.module.student(wavs, wav_lens, generator=generator if train else None,
                                            mask_indices=mask)
        pred = student_hs[-1][:, :T].float()
        err = ((pred - targets) ** 2).mean(-1)
        sel = mask & valid
        loss = torch.where(sel, err, 0.0).sum() / torch.clamp(sel.sum(), min=1)
        target_var = torch.sqrt(targets.var(dim=(0, 1), unbiased=False) + 1e-6).mean()
        return loss, {"loss": loss.detach(), "target_var": target_var}

    def reduction(self, mode: str, records: List[Dict[str, Any]]) -> Dict[str, float]:
        return {
            "loss": float(np.mean([float(r["loss"]) for r in records])),
            "target_var": float(np.mean([float(r["target_var"]) for r in records])),
        }
