"""MOS prediction task (port of s3prl_tpu/task/mos_prediction.py; the
reference's downstream/mos_prediction).

Behavioral spec from the reference expert (downstream/mos_prediction/
model.py:35-73, expert.py:118-175): every utterance is scored per 1 s
segment (0.5 s hop) by a mean-net (self-attention pooling + linear, optional
tanh*2+3 clipping); training adds a judge-bias net (judge embedding added to
the features, its own pooling + linear, bias score = bias + segment score)
and minimizes

    segment_weight * MSE(seg_scores, utt_mean)
  + bias_weight   * MSE(bias_utt_score, judge_opinion)
  +                 MSE(utt_score, utt_mean)

Evaluation reports utterance- and system-level MSE / LCC (Pearson) / SRCC
(Spearman) like expert.py:214-260, on the host through scipy.

As in the JAX package, the upstream runs once per utterance and the
segments are cut from the 50 fps states (windows of `seg_frames` = 50, hop
25): their number follows the batch's padded T (``T // hop`` when T > W,
else 1), the attention pooling's softmax runs over all W frames of a
segment, padding included, and the valid segments come from ``h_lens``.
"""

from __future__ import annotations

from typing import Any, Dict, List

import numpy as np
import torch
import torch.nn as nn
import torch.nn.functional as F

from .base import Task
from ..nn.heads import Dense
from ..nn.upstream import Featurizer


class MosDownstreamModule(nn.Module):
    """Featurizer + segment mean-net + judge bias-net; the layers keep
    flax's names (``judge_embedding`` an ``nn.Embedding``).

    forward(hs, h_lens, judge_ids=None) ->
        (seg_scores [B, S], bias_scores [B, S] | None, seg_mask [B, S])
    """

    def __init__(self, num_layers: int, input_size: int, projector_dim: int = 256,
                 num_judges: int = 5000, clipping: bool = True,
                 attention_pooling: bool = True, seg_frames: int = 50, hop_frames: int = 25):
        super().__init__()
        self.clipping, self.attention_pooling = clipping, attention_pooling
        self.seg_frames, self.hop_frames = seg_frames, hop_frames
        self.featurizer = Featurizer(num_layers)
        self.connector = Dense(input_size, projector_dim)
        if attention_pooling:
            self.mean_net_pooling = Dense(projector_dim, 1)
        self.mean_net_linear = Dense(projector_dim, 1)
        self.judge_embedding = nn.Embedding(num_judges, projector_dim)
        if attention_pooling:
            self.bias_net_pooling = Dense(projector_dim, 1)
        self.bias_net_linear = Dense(projector_dim, 1)

    def _pool_score(self, y: torch.Tensor, net: str) -> torch.Tensor:
        linear = getattr(self, f"{net}_linear")
        if self.attention_pooling:
            att = getattr(self, f"{net}_pooling")(y)
            pooled = (y * torch.softmax(att, dim=1)).sum(dim=1)
            return linear(pooled)[:, 0]
        return linear(y)[..., 0].mean(dim=-1)

    def forward(self, hs, h_lens, judge_ids=None, generator=None):
        feat, _ = self.featurizer(hs, h_lens)
        B, T, H = feat.shape
        W, hop = self.seg_frames, self.hop_frames
        n_seg = max(T // hop, 1) if T > W else 1
        pad_to = (n_seg - 1) * hop + W
        feat = F.pad(feat, (0, 0, 0, max(pad_to - T, 0)))
        segs = feat.unfold(1, W, hop)[:, :n_seg].transpose(2, 3)  # [B, S, W, H]
        x = self.connector(segs.reshape(B * n_seg, W, H).float())
        seg = self._pool_score(x, "mean_net")
        if self.clipping:
            seg = torch.tanh(seg) * 2.0 + 3.0
        seg_scores = seg.reshape(B, n_seg)

        h_lens = h_lens.to(feat.device)
        n_valid = torch.clamp(torch.where(h_lens <= W, 1, h_lens // hop), 1, n_seg)
        seg_mask = (torch.arange(n_seg, device=feat.device)[None] < n_valid[:, None]).float()

        bias_scores = None
        if judge_ids is not None:
            emb = self.judge_embedding(judge_ids)  # [B, D]
            bx = (x.reshape(B, n_seg, W, -1) + emb[:, None, None, :]).reshape(B * n_seg, W, -1)
            bias_scores = self._pool_score(bx, "bias_net").reshape(B, n_seg) + seg_scores
        return seg_scores, bias_scores, seg_mask


class MosPredictionTask(Task):
    """Batch: x wavs, 'mean' [B] f32, 'mos' [B] f32 (judge opinion),
    'judge_id' [B] int, host 'system_name' + 'unique_name'. The judge
    embedding and the bias net run only in training on a batch that
    carries 'judge_id'."""

    def __init__(self, module: MosDownstreamModule, segment_weight: float = 1.0,
                 bias_weight: float = 1.0):
        self.module = module
        self.segment_weight = segment_weight
        self.bias_weight = bias_weight
        self.host_keys = ("system_name", "unique_name")

    valid_metric = "utt_MSE"
    valid_higher_better = False

    def loss_and_cache(self, hs, h_lens, batch, generator, train):
        if self.module.training != train:
            self.module.train(train)
        dev = hs.device
        judge_ids = None
        if train and batch.get("judge_id") is not None:
            judge_ids = torch.as_tensor(np.asarray(batch["judge_id"]), device=dev).long()
        seg_scores, bias_scores, mask = self.module(hs, h_lens, judge_ids=judge_ids)
        denom = torch.clamp(mask.sum(-1), min=1.0)
        utt_score = (seg_scores * mask).sum(-1) / denom
        mean = torch.as_tensor(np.asarray(batch["mean"]), device=dev).float()
        seg_loss = (((seg_scores - mean[:, None]) ** 2) * mask).sum() / torch.clamp(
            mask.sum(), min=1.0)
        utt_loss = ((utt_score - mean) ** 2).mean()
        loss = self.segment_weight * seg_loss + utt_loss
        if bias_scores is not None:
            bias_utt = (bias_scores * mask).sum(-1) / denom
            mos = torch.as_tensor(np.asarray(batch["mos"]), device=dev).float()
            loss = loss + self.bias_weight * ((bias_utt - mos) ** 2).mean()
        return loss, {"loss": loss.detach(), "prediction": utt_score.detach(), "mean": mean}

    def reduction(self, mode: str, records: List[Dict[str, Any]]) -> Dict[str, float]:
        from scipy import stats

        pred = np.concatenate([np.atleast_1d(r["prediction"]) for r in records])
        true = np.concatenate([np.atleast_1d(r["mean"]) for r in records])
        out = {
            "loss": float(np.mean([float(r["loss"]) for r in records])),
            "utt_MSE": float(np.mean((pred - true) ** 2)),
        }
        if len(pred) > 1 and np.std(pred) > 0 and np.std(true) > 0:
            out["utt_LCC"] = float(np.corrcoef(pred, true)[0, 1])
            out["utt_SRCC"] = float(stats.spearmanr(pred, true).statistic)
        systems = []
        for r in records:
            systems.extend(r.get("system_name", []))
        if systems and len(systems) == len(pred):
            by_sys: Dict[str, list] = {}
            for s, p, t in zip(systems, pred, true):
                by_sys.setdefault(s, []).append((p, t))
            sp = np.asarray([np.mean([x[0] for x in v]) for v in by_sys.values()])
            st_ = np.asarray([np.mean([x[1] for x in v]) for v in by_sys.values()])
            out["sys_MSE"] = float(np.mean((sp - st_) ** 2))
            if len(sp) > 1 and np.std(sp) > 0 and np.std(st_) > 0:
                out["sys_LCC"] = float(np.corrcoef(sp, st_)[0, 1])
                out["sys_SRCC"] = float(stats.spearmanr(sp, st_).statistic)
        return out
