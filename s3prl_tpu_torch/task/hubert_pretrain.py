"""HuBERT masked-unit prediction pretraining (port of
s3prl_tpu/task/hubert_pretrain.py; the reference's hubert_model.py:
forward:465-560): span-mask the conv features, predict the k-means unit of
every masked (and, weighted, unmasked) frame through cosine logits against
the unit embeddings; cross-entropy over the units.

The mask is the static-bound `compute_mask_indices` drawn from the step's
generator on the card; the loss is a masked CE over the whole [B, T,
units] logits. The task drives its trunk on the waveform itself: the
Trainer's upstream is ``wav``, whose lengths bound the valid frames.
"""

from __future__ import annotations

from typing import Any, Dict, List

import numpy as np
import torch
import torch.nn.functional as F

from .base import Task, device_labels
from ..ops.masking import compute_mask_indices, length_mask


def device_wavs(batch: Dict[str, Any], device):
    """The batch's waves [B, T] f32 and lengths [B] int64 on `device`."""
    wavs = torch.as_tensor(batch["x"], device=device).float()
    if wavs.ndim == 3:
        wavs = wavs[..., 0]
    return wavs, device_labels(batch, "x_len", device)


def init_trunk(module, generator) -> None:
    """A wav2vec2-family model's random weights as the registry's
    (`upstream.registry._init_trunk`: flax's initialisers)."""
    from ..upstream.registry import _init_trunk

    _init_trunk(module, generator)


class HubertPretrainTask(Task):
    """module: `HubertForPretrain` — (wavs, wav_lens, mask_indices,
    generator) -> (logits [B, T, num_units], feat_lens)."""

    def __init__(self, module, mask_prob: float = 0.8, mask_length: int = 10,
                 pred_masked_weight: float = 1.0, pred_nomask_weight: float = 0.0):
        self.module = module
        self.mask_prob = mask_prob
        self.mask_length = mask_length
        self.pred_masked_weight = pred_masked_weight
        self.pred_nomask_weight = pred_nomask_weight
        self.host_keys = ()

    valid_metric = "masked_acc"
    valid_higher_better = True

    @torch.no_grad()
    def init_params(self, generator=None) -> None:
        """The trunk as the registry's, ``final_proj`` lecun-normal with a
        zero bias, the unit embeddings uniform in [0, 1)."""
        m = self.module
        init_trunk(m.trunk, generator)
        w = m.final_proj.weight
        w.copy_(torch.randn(w.shape, generator=generator) / w.shape[1] ** 0.5)
        m.final_proj.bias.zero_()
        m.label_embs.copy_(torch.rand(m.label_embs.shape, generator=generator))

    def loss_and_cache(self, hs, h_lens, batch, generator, train):
        dev = hs.device
        wavs, wav_lens = device_wavs(batch, dev)
        units = device_labels(batch, "units", dev)  # [B, T_feat], padded
        T_feat = units.shape[1]
        feat_valid = length_mask(torch.minimum(h_lens.to(dev), device_labels(
            batch, "units_len", dev)), T_feat)
        mask = compute_mask_indices(generator, (wavs.shape[0], T_feat), ~feat_valid,
                                    self.mask_prob, self.mask_length, device=dev)
        if self.module.training != train:
            self.module.train(train)
        logits, _ = self.module(wavs, wav_lens, mask, generator if train else None)
        T = min(logits.shape[1], T_feat)
        logits, units_t = logits[:, :T], units[:, :T]
        mask_t, valid_t = mask[:, :T], feat_valid[:, :T]
        ce = F.cross_entropy(logits.transpose(1, 2), torch.clamp(units_t, min=0),
                             reduction="none")
        masked, unmasked = mask_t & valid_t, ~mask_t & valid_t
        n_m = torch.clamp(masked.sum(), min=1)
        loss_m = torch.where(masked, ce, 0.0).sum() / n_m
        loss_u = torch.where(unmasked, ce, 0.0).sum() / torch.clamp(unmasked.sum(), min=1)
        loss = self.pred_masked_weight * loss_m + self.pred_nomask_weight * loss_u
        correct = masked & (logits.argmax(-1) == units_t)
        masked_acc = correct.sum() / n_m
        return loss, {"loss": loss.detach(), "loss_masked": loss_m.detach(),
                      "masked_acc": masked_acc}

    def reduction(self, mode: str, records: List[Dict[str, Any]]) -> Dict[str, float]:
        return {
            "loss": float(np.mean([float(r["loss"]) for r in records])),
            "masked_acc": float(np.mean([float(r["masked_acc"]) for r in records])),
        }
