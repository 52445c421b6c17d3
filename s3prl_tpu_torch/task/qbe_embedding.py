"""Learned query-by-example embedding task (port of s3prl_tpu/task/
qbe_embedding.py; the reference's downstream/quesst14_embedding/
expert.py:89-125 + model.py, downstream/sws2013).

A query and a candidate document are embedded by connector -> LSTM ->
tanh -> attentive pooling; training minimizes the cosine-embedding loss
(pos: 1 - cos, neg: clamp(cos - margin, 0), margin 0 for quesst14 and -1
for sws2013, sws2013/config.yaml lossrc.margin). Batches are (query, doc,
label) pairs, as in the JAX package (its documented divergence from the
reference's max over a candidate list).
"""

from __future__ import annotations

from typing import Any, Dict, List

import numpy as np
import torch
import torch.nn as nn
import torch.nn.functional as F

from .base import Task
from ..nn.heads import LSTM, Dense, _valid
from ..nn.upstream import Featurizer


class QbeEmbedder(nn.Module):
    """featurizer -> connector -> ReLU -> unidirectional `LSTM` stack
    (``lstm_{i}``, flax's ``OptimizedLSTMCell_{i}``) -> tanh -> attentive
    pooling (quesst14_embedding/model.py:6-29), the padded frames masked out
    of the pooling with -1e9; returns [B, hidden_dim] f32. `h_lens` should
    be a host tensor (``pack_padded_sequence`` takes its lengths there)."""

    def __init__(self, num_layers_upstream: int, input_size: int, bottleneck_dim: int = 256,
                 hidden_dim: int = 1024, num_layers: int = 2):
        super().__init__()
        self.num_layers = num_layers
        self.featurizer = Featurizer(num_layers_upstream)
        self.connector = Dense(input_size, bottleneck_dim)
        for i in range(num_layers):
            self.add_module(f"lstm_{i}", LSTM(bottleneck_dim if i == 0 else hidden_dim,
                                              hidden_dim, bidirectional=False))
        self.attention_linear = Dense(hidden_dim, 1)

    def forward(self, hs, h_lens, generator=None):
        feat, _ = self.featurizer(hs, h_lens)
        x = F.relu(self.connector(feat.float()))
        lens = h_lens.cpu()
        for i in range(self.num_layers):
            x = getattr(self, f"lstm_{i}")(x, lens)
        x = torch.tanh(x)
        att = self.attention_linear(x)[..., 0]
        att = torch.where(_valid(x, h_lens), att, -1e9)
        w = torch.softmax(att, dim=-1)
        return torch.einsum("bt,bth->bh", w, x)


def _unit(x: torch.Tensor) -> torch.Tensor:
    return x / torch.clamp(torch.linalg.vector_norm(x, dim=-1, keepdim=True), min=1e-8)


class QbeEmbeddingTask(Task):
    """Batch: x = [query_0..query_B, doc_0..doc_B] wavs, 'pair_label' [2B]
    in {+1, -1} (the pairs' labels, repeated for the documents)."""

    def __init__(self, module: QbeEmbedder, margin: float = 0.0):
        self.module = module
        self.margin = margin
        self.host_keys = ("unique_name",)

    valid_metric = "loss"
    valid_higher_better = False

    def loss_and_cache(self, hs, h_lens, batch, generator, train):
        emb = self._apply(hs, h_lens, generator, train)
        n = emb.shape[0] // 2
        sim = (_unit(emb[:n]) * _unit(emb[n:2 * n])).sum(-1)
        labels = torch.as_tensor(np.asarray(batch["pair_label"])[:n],
                                 device=emb.device).float()
        pos = torch.where(labels > 0, 1.0 - sim, 0.0)
        neg = torch.where(labels < 0, torch.clamp(sim - self.margin, min=0.0), 0.0)
        loss = (pos + neg).sum() / n
        return loss, {"loss": loss.detach(), "similarity": sim.detach(), "pair_label": labels}

    def reduction(self, mode: str, records: List[Dict[str, Any]]) -> Dict[str, float]:
        sims = np.concatenate([np.atleast_1d(r["similarity"]) for r in records])
        labels = np.concatenate([np.atleast_1d(r["pair_label"]) for r in records])
        out = {"loss": float(np.mean([float(r["loss"]) for r in records]))}
        pos, neg = sims[labels > 0], sims[labels < 0]
        if len(pos) and len(neg):
            # pairwise retrieval AUC: P(pos pair scores above neg pair)
            out["pair_auc"] = float((pos[:, None] > neg[None, :]).mean())
        return out
