"""The CTC loss of the JAX package's CTC task (``optax.ctc_loss``, its
``log_epsilon = -1e5`` in place of log 0), per sequence.

A row whose frames can emit its labels (``frames >= labels + repeats``, at
least one frame) takes ``F.ctc_loss`` (one launch on the card for all such
rows), whose value and gradient are optax's up to rounding. optax gives
every other row a finite value near ``-log_epsilon`` (about 1e5) with a
gradient, where ``F.ctc_loss`` gives inf: those rows take
`ctc_loss_reference`, a plain PyTorch copy of optax's recursion, with
autograd through it. The rows are told apart on the host from the lengths,
which are host tensors here (the packed LSTM needs them there too), so the
split costs no device sync.
"""

from __future__ import annotations

from typing import Tuple

import numpy as np
import torch
import torch.nn.functional as F

LOG_EPSILON = -1e5  # optax.ctc_loss's approximation of log(0)


class _LogAddExp(torch.autograd.Function):
    """``jnp.logaddexp`` with JAX's derivative, ``exp(x - out)``. Near
    ``log_epsilon`` the output's rounding (1e5 carries steps of 2**-7)
    enters that derivative, so optax's gradient of an infeasible row is
    matched only by the same rule (``torch.logaddexp``'s ``1 / (1 +
    exp(y - x))`` differs there by up to 1%)."""

    @staticmethod
    def forward(ctx, x1, x2):
        out = torch.maximum(x1, x2) + torch.log1p(torch.exp(-torch.abs(x1 - x2)))
        ctx.save_for_backward(x1, x2, out)
        return out

    @staticmethod
    def backward(ctx, grad):
        x1, x2, out = ctx.saved_tensors
        return grad * torch.exp(x1 - out), grad * torch.exp(x2 - out)


def _logaddexp(x1: torch.Tensor, x2: torch.Tensor) -> torch.Tensor:
    x1, x2 = torch.broadcast_tensors(x1, x2)
    return _LogAddExp.apply(x1, x2)


def _logaddexp_phi(phi: torch.Tensor, added: torch.Tensor) -> torch.Tensor:
    """optax's ``update_phi_score``: phi[:, 1:] log-added with `added`."""
    return torch.cat([phi[:, :1], _logaddexp(phi[:, 1:], added)], dim=-1)


def ctc_loss_reference(log_probs: torch.Tensor, logit_lens: torch.Tensor, labels: torch.Tensor,
                       label_lens: torch.Tensor, blank_id: int = 0,
                       log_epsilon: float = LOG_EPSILON) -> torch.Tensor:
    """optax.ctc_loss_with_forward_probs's per-sequence loss in PyTorch.

    log_probs [B, T, K] (log-softmaxed), logit_lens [B], labels [B, N]
    (right-padded), label_lens [B] -> [B]. The recursion runs over the
    frames up to the longest row; optax's padded frames carry the state
    unchanged, so the frames after it do not change the result."""
    B, _, _ = log_probs.shape
    dev = log_probs.device
    steps = int(logit_lens.max()) if B else 0  # host lengths: no device sync
    labels = labels.to(dev).long()
    N = labels.shape[1]
    label_lens = label_lens.to(dev).long()
    logit_lens = logit_lens.to(dev).long()
    repeat = F.pad((labels[:, :-1] == labels[:, 1:]).to(log_probs.dtype), (0, 1))  # [B, N]
    emit = log_probs.gather(2, labels[:, None, :].expand(-1, log_probs.shape[1], -1))  # [B, T, N]
    blank = log_probs[:, :, blank_id]  # [B, T]
    phi = torch.full((B, N + 1), log_epsilon, dtype=log_probs.dtype, device=dev)
    phi[:, 0] = 0.0
    em = torch.full((B, N), log_epsilon, dtype=log_probs.dtype, device=dev)
    for t in range(steps):
        pad = (t >= logit_lens).to(log_probs.dtype)[:, None]
        prev_phi_orig = phi
        prev_phi = _logaddexp_phi(phi, em + log_epsilon * repeat)
        next_emit = _logaddexp(prev_phi[:, :-1] + emit[:, t], em + emit[:, t])
        next_phi = prev_phi + blank[:, t, None]
        next_phi = _logaddexp_phi(next_phi, em + blank[:, t, None] + log_epsilon * (1.0 - repeat))
        em = pad * em + (1.0 - pad) * next_emit
        phi = pad * prev_phi_orig + (1.0 - pad) * next_phi
    phi_last = _logaddexp_phi(phi, em)
    return -phi_last.gather(1, label_lens[:, None])[:, 0]


def _routes(logit_lens: np.ndarray, labels: np.ndarray, label_lens: np.ndarray
            ) -> Tuple[np.ndarray, np.ndarray]:
    """(rows for F.ctc_loss, rows for the plain recursion)."""
    valid = np.arange(labels.shape[1])[None, :] < label_lens[:, None] - 1
    repeats = ((labels[:, 1:] == labels[:, :-1]) & valid[:, :-1]).sum(axis=1)
    feasible = (logit_lens > 0) & (logit_lens >= label_lens + repeats)
    return np.flatnonzero(feasible), np.flatnonzero(~feasible)


def ctc_loss(logits: torch.Tensor, logit_lens: torch.Tensor, labels, label_lens,
             blank_id: int = 0) -> torch.Tensor:
    """optax.ctc_loss(logits, logit_paddings, labels, label_paddings,
    blank_id) per sequence: logits [B, T, K] (computed in f32), logit_lens
    [B] on the host, labels [B, N] right-padded and label_lens [B] (numpy or
    host tensors) -> [B] f32 on the logits' device."""
    log_probs = F.log_softmax(logits.float(), dim=-1)
    lens_np = np.asarray(logit_lens.cpu() if torch.is_tensor(logit_lens) else logit_lens,
                         np.int64)
    labels_np = np.asarray(labels.cpu() if torch.is_tensor(labels) else labels, np.int64)
    label_lens_np = np.asarray(label_lens.cpu() if torch.is_tensor(label_lens) else label_lens,
                               np.int64)
    fast, plain = _routes(lens_np, labels_np, label_lens_np)
    dev = log_probs.device
    per_seq = log_probs.new_zeros(len(lens_np))
    if len(fast):
        lp = log_probs if len(fast) == len(lens_np) else log_probs[torch.from_numpy(fast).to(dev)]
        per_seq = per_seq.index_put((torch.from_numpy(fast).to(dev),), F.ctc_loss(
            lp.transpose(0, 1), torch.from_numpy(labels_np[fast]).to(dev),
            torch.from_numpy(lens_np[fast]), torch.from_numpy(label_lens_np[fast]),
            blank=blank_id, reduction="none", zero_infinity=False))
    if len(plain):
        rows = torch.from_numpy(plain).to(dev)
        per_seq = per_seq.index_put((rows,), ctc_loss_reference(
            log_probs[rows], torch.from_numpy(lens_np[plain]), torch.from_numpy(labels_np[plain]),
            torch.from_numpy(label_lens_np[plain]), blank_id))
    return per_seq
