"""Speaker verification tasks, SUPERB ASV (port of s3prl_tpu/task/
speaker_verification.py).

Behavioral spec from the reference's SpeakerVerification task
(s3prl/task/speaker_verification_task.py:62-209): train a speaker classifier
with the AM-softmax margin loss over x-vector embeddings, or the GE2E loss
over speaker-grouped batches; evaluate by cosine-scoring trial pairs and
reducing to EER / minDCF (host numpy, the JAX package's code).

The JAX tasks keep their parameters (``am_weight``; ``ge2e_w``,
``ge2e_b``) at the top of the params tree, so the optimizer updates them,
the global clip norm counts them, AdamW decays them and the checkpoints
hold them. Here they are parameters of the task's module (registered on it
at construction, at the top of its state_dict), for the same reasons.
"""

from __future__ import annotations

from typing import Any, Dict, List, Tuple

import numpy as np
import torch
import torch.nn as nn
import torch.nn.functional as F

from .base import Task, device_labels
from ..metric import compute_eer, compute_minDCF


def _unit(x: torch.Tensor, dim: int) -> torch.Tensor:
    """x over its norm along `dim`, the norm floored at 1e-8."""
    return x / torch.clamp(torch.linalg.vector_norm(x, dim=dim, keepdim=True), min=1e-8)


def amsoftmax_logits(
    embs: torch.Tensor,  # [B, D]
    weight: torch.Tensor,  # [D, C] (column-normalized at use)
    labels: torch.Tensor,  # [B]
    margin: float = 0.4,
    scale: float = 30.0,
) -> torch.Tensor:
    """Additive-margin softmax logits (reference: nn/speaker_loss.py amsoftmax)."""
    cos = _unit(embs, -1) @ _unit(weight, 0)  # [B, C]
    onehot = F.one_hot(labels, cos.shape[-1]).to(cos.dtype)
    return scale * (cos - margin * onehot)


class SpeakerVerificationTask(Task):
    """Training = AM-softmax classification; testing = trial cosine scoring.
    `module` is an UpstreamDownstreamModel whose downstream has an
    ``output_size`` (the embedding's width D); ``am_weight`` [D,
    num_speakers] is drawn N(0, 1) x 0.01 after the module's init."""

    def __init__(self, module, num_speakers: int, margin: float = 0.4, scale: float = 30.0):
        self.module = module  # maps (hs, h_lens) -> embeddings [B, D]
        self.num_speakers = num_speakers
        self.margin = margin
        self.scale = scale
        self.host_keys = ("unique_name",)
        module.register_parameter("am_weight", nn.Parameter(
            torch.zeros(module.downstream.output_size, num_speakers)))

    valid_metric = "eer"
    valid_higher_better = False

    def init_params(self, generator=None) -> None:
        super().init_params(generator)
        w = self.module.am_weight
        with torch.no_grad():
            w.copy_(torch.randn(w.shape, generator=generator) * 0.01)

    def _embed(self, hs, h_lens, generator=None, train=False) -> torch.Tensor:
        emb = self._apply(hs, h_lens, generator, train)
        return emb[0] if isinstance(emb, tuple) else emb

    def embed(self, hs, h_lens) -> torch.Tensor:
        """The eval-mode embeddings [B, D] of the states, without autograd."""
        with torch.no_grad():
            return self._embed(hs, h_lens)

    def loss_and_cache(self, hs, h_lens, batch, generator, train):
        emb = self._embed(hs, h_lens, generator, train)
        labels = device_labels(batch, "class_id", emb.device)
        logits = amsoftmax_logits(emb, self.module.am_weight, labels, self.margin, self.scale)
        loss = F.cross_entropy(logits, labels)
        pred = torch.argmax(logits, dim=-1)
        return loss, {"loss": loss.detach(), "prediction": pred, "label": labels,
                      "embedding": emb.detach()}

    def reduction(self, mode: str, records: List[Dict[str, Any]]) -> Dict[str, float]:
        preds = np.concatenate([r["prediction"] for r in records])
        labels = np.concatenate([r["label"] for r in records])
        losses = [float(r["loss"]) for r in records]
        return {"accuracy": float((preds == labels).mean()), "loss": float(np.mean(losses))}

    @staticmethod
    def score_trials(
        emb_by_name: Dict[str, np.ndarray], trials: List[Tuple[int, str, str]]
    ) -> Dict[str, float]:
        """trials: (label, name_a, name_b) -> EER/minDCF over cosine scores."""
        scores, labels = [], []
        for label, a, b in trials:
            ea, eb = emb_by_name[a], emb_by_name[b]
            s = float(ea @ eb / (np.linalg.norm(ea) * np.linalg.norm(eb) + 1e-8))
            scores.append(s)
            labels.append(int(label))
        eer, _ = compute_eer(labels, scores)
        mindcf, _ = compute_minDCF(labels, scores)
        return {"eer": eer, "minDCF": mindcf}


def ge2e_loss(
    embs: torch.Tensor,  # [N_spk, M_utt, D]
    w: torch.Tensor,  # learned scale (init 10.0)
    b: torch.Tensor,  # learned bias (init -5.0)
) -> torch.Tensor:
    """Generalized end-to-end softmax loss (reference: downstream/
    voxceleb2_ge2e - GE2E, Wan et al. 2018): each utterance is scored
    against every speaker centroid (its own speaker's centroid excludes the
    utterance) and trained with softmax CE toward its own speaker."""
    N, M, D = embs.shape
    e = _unit(embs, -1)
    cent_n = _unit(e.mean(dim=1), -1)  # [N, D]
    excl = _unit((e.sum(dim=1, keepdim=True) - e) / (M - 1), -1)  # [N, M, D]
    sim = torch.einsum("nmd,kd->nmk", e, cent_n)  # [N, M, N]
    own = torch.sum(e * excl, dim=-1)  # [N, M]
    eye = torch.eye(N, dtype=torch.bool, device=embs.device)[:, None, :]
    logits = w * torch.where(eye, own[..., None], sim) + b
    labels = torch.arange(N, device=embs.device)[:, None].expand(N, M)
    return F.cross_entropy(logits.reshape(N * M, N), labels.reshape(N * M))


class Ge2eVerificationTask(SpeakerVerificationTask):
    """GE2E-trained speaker verification (reference: downstream/
    voxceleb2_ge2e/expert.py:118-133): batches are speaker-grouped [N_spk *
    M_utt] (GE2EBatchSampler's speaker-major order), the embeddings reshape
    to [N, M, D] for the GE2E loss; trials score by cosine like the
    AM-softmax task. The scale ``ge2e_w`` (init 10, clamped at 1e-6 at use)
    and bias ``ge2e_b`` (init -5) are trained parameters of the module."""

    def __init__(self, module, utts_per_speaker: int = 10):
        self.module = module
        self.utts_per_speaker = utts_per_speaker
        self.host_keys = ("unique_name",)
        module.register_parameter("ge2e_w", nn.Parameter(torch.tensor(10.0)))
        module.register_parameter("ge2e_b", nn.Parameter(torch.tensor(-5.0)))

    valid_metric = "loss"
    valid_higher_better = False

    def init_params(self, generator=None) -> None:
        Task.init_params(self, generator)
        with torch.no_grad():
            self.module.ge2e_w.fill_(10.0)
            self.module.ge2e_b.fill_(-5.0)

    def loss_and_cache(self, hs, h_lens, batch, generator, train):
        emb = self._embed(hs, h_lens, generator, train)
        M = self.utts_per_speaker
        B, D = emb.shape
        N = B // M
        # GE2E's w must stay positive (Wan et al. 2018 eq. 5 gradient note)
        w = torch.clamp(self.module.ge2e_w, min=1e-6)
        loss = ge2e_loss(emb[: N * M].reshape(N, M, D), w, self.module.ge2e_b)
        return loss, {"loss": loss.detach(), "embedding": emb.detach()}

    def reduction(self, mode: str, records: List[Dict[str, Any]]) -> Dict[str, float]:
        return {"loss": float(np.mean([float(r["loss"]) for r in records]))}
