"""Masked, autoregressive and corrupted acoustic reconstruction (SSL
pretraining; port of s3prl_tpu/task/reconstruction.py):

- masked reconstruction (Mockingjay / TERA / AudioALBERT): MAM-masked
  features -> encoder -> prediction head -> L1 (or L2) on the masked frames
  (the reference's pretrain/mockingjay/pretrain_expert.py);
- autoregressive reconstruction (APC / VQ-APC): predict the features
  ``n_future`` frames ahead (pretrain/apc/); VQ-APC's Gumbel noise comes from
  the step's generator;
- NPC: reconstruct every valid frame from its masked conv context, the
  BatchNorms on the batch's statistics with the running ones left as they
  are (pretrain/npc/pretrain_expert.py);
- SpecAugment corruption: LD-policy frequency and time bands zeroed inside
  each utterance, the masked cells reconstructed (pretrain/spec_augment/).

Each module maps (feats [B, T, D], feat_lens, generator) to (pred [B, T, D],
lens); the features are the Trainer's frozen upstream's (``mel`` or
``fbank``) states [1, B, T, D].
"""

from __future__ import annotations

from typing import Any, Dict, List

import numpy as np
import torch

from .base import Task
from ..nn.specaug import band_mask, draw_bands
from ..ops.mam import mam_mask
from ..ops.masking import length_mask


def _features(feats: torch.Tensor) -> torch.Tensor:
    return feats[0] if feats.ndim == 4 else feats  # one stacked layer [1, B, T, D]


def _masked_error(pred, target, loss: str):
    diff = pred - target
    return diff.abs() if loss == "L1" else diff ** 2


class _ReconstructionTask(Task):
    host_keys = ()
    valid_metric = "loss"
    valid_higher_better = False

    def _run(self, feats, feat_lens, generator, train):
        if self.module.training != train:
            self.module.train(train)
        return self.module(feats, feat_lens, generator if train else None)

    def reduction(self, mode: str, records: List[Dict[str, Any]]) -> Dict[str, float]:
        return {"loss": float(np.mean([float(r["loss"]) for r in records]))}


class MaskedReconstructionTask(_ReconstructionTask):
    """module: (masked feats, feat_lens, generator) -> (pred [B, T, D], lens)."""

    def __init__(self, module, loss: str = "L1", mask_proportion: float = 0.15,
                 mask_consecutive: int = 7, mask_frequency: float = 0.0):
        self.module = module
        self.loss = loss
        self.mask_kwargs = dict(mask_proportion=mask_proportion,
                                mask_consecutive=mask_consecutive,
                                mask_frequency=mask_frequency)

    def loss_and_cache(self, feats, feat_lens, batch, generator, train):
        feats = _features(feats)
        masked, label_mask = mam_mask(generator, feats, feat_lens, **self.mask_kwargs)
        pred, _ = self._run(masked, feat_lens, generator, train)
        T = pred.shape[1]
        label_mask = label_mask[:, :T]
        err = _masked_error(pred, feats[:, :T], self.loss)
        denom = torch.clamp(label_mask.sum(), min=1) * feats.shape[-1]
        loss = torch.where(label_mask[..., None], err, 0.0).sum() / denom
        return loss, {"loss": loss.detach()}


class AutoregressiveReconstructionTask(_ReconstructionTask):
    """Predict the features ``n_future`` frames ahead (the APC objective)."""

    def __init__(self, module, n_future: int = 5, loss: str = "L1"):
        self.module = module
        self.n_future = n_future
        self.loss = loss

    def loss_and_cache(self, feats, feat_lens, batch, generator, train):
        feats = _features(feats)
        pred, _ = self._run(feats, feat_lens, generator, train)
        n = self.n_future
        target = feats[:, n:]
        pred = pred[:, :pred.shape[1] - n]
        valid = length_mask(torch.clamp(feat_lens - n, min=0), target.shape[1])
        err = _masked_error(pred, target, self.loss)
        denom = torch.clamp(valid.sum(), min=1) * feats.shape[-1]
        loss = torch.where(valid[..., None], err, 0.0).sum() / denom
        return loss, {"loss": loss.detach()}


class NpcReconstructionTask(_ReconstructionTask):
    """NPC: reconstruct every valid frame from its masked context. Train
    mode leaves the BatchNorms' running statistics as they are (a JAX
    checkpoint keeps its init ones)."""

    def __init__(self, module, loss: str = "L1"):
        self.module = module
        self.loss = loss

    def loss_and_cache(self, feats, feat_lens, batch, generator, train):
        feats = _features(feats)
        pred, _ = self._run(feats, feat_lens, generator, train)
        valid = length_mask(feat_lens, pred.shape[1])
        err = _masked_error(pred, feats[:, :pred.shape[1]], self.loss)
        denom = torch.clamp(valid.sum(), min=1) * feats.shape[-1]
        loss = torch.where(valid[..., None], err, 0.0).sum() / denom
        return loss, {"loss": loss.detach()}


def spec_masks(generator, B: int, T: int, D: int, freq_mask_num: int, freq_mask_width: int,
               time_mask_num: int, time_mask_width: int):
    """(frequency mask [B, D], time mask [B, T]) of the bands drawn from
    `generator`, frequency first (`nn.specaug.draw_bands`)."""
    fmask = band_mask(*draw_bands(generator, B, D, freq_mask_num, freq_mask_width), D)
    tmask = band_mask(*draw_bands(generator, B, T, time_mask_num, time_mask_width), T)
    return fmask, tmask


class SpecAugReconstructionTask(_ReconstructionTask):
    """SpecAugment pretraining: the LD-policy bands zero the input's cells
    inside each utterance, and the loss runs over those cells."""

    def __init__(self, module, loss: str = "L1", freq_mask_width: int = 27,
                 freq_mask_num: int = 2, time_mask_width: int = 100, time_mask_num: int = 2):
        self.module = module
        self.loss = loss
        self.band_kwargs = dict(freq_mask_num=freq_mask_num, freq_mask_width=freq_mask_width,
                                time_mask_num=time_mask_num, time_mask_width=time_mask_width)

    def loss_and_cache(self, feats, feat_lens, batch, generator, train):
        feats = _features(feats)
        B, T, D = feats.shape
        fmask, tmask = spec_masks(generator, B, T, D, **self.band_kwargs)
        valid = length_mask(feat_lens, T)
        cell_mask = (fmask[:, None, :] | tmask[:, :, None]) & valid[:, :, None]
        pred, _ = self._run(torch.where(cell_mask, 0.0, feats), feat_lens, generator, train)
        cell_mask = cell_mask[:, :pred.shape[1]]
        err = _masked_error(pred, feats[:, :pred.shape[1]], self.loss)
        loss = torch.where(cell_mask, err, 0.0).sum() / torch.clamp(cell_mask.sum(), min=1)
        return loss, {"loss": loss.detach()}
