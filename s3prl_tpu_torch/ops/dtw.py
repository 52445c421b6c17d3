"""Dynamic time warping for query-by-example spoken term detection (port of
s3prl_tpu/ops/dtw.py).

Behavioral spec from the reference's QbE recipe (s3prl/downstream/
quesst14_dtw, dtw-python in subsequence mode with the cosine distance): a
query is slid over a document; the score is the negative minimal-cost
subsequence alignment, normalised by the query's length.

The DP runs on the tensors' device with stock ops: a loop over the query
rows on ``[Q, n, Td]`` tensors, every query against a chunk of ``n``
documents at once. The JAX package's vmap holds every (query, doc) pair's
``[Tq, Td]`` cost matrix at once; here the documents go in chunks whose
cost tensor stays under ``max_gib``, each chunk cut to its longest
document. A valid cell depends only on the cells at or left of it, so
neither the chunking nor the cut changes a score.

Within a row, ``cur[j] = cost[j] + min(prev[j], prev[j-1], cur[j-1])`` is a
min-plus prefix: with ``base[j] = cost[j] + min(prev[j], prev[j-1])`` (f32,
as in JAX) and ``S = cumsum(cost)``, ``cur[j] = S[j] + min_{k<=j}(base[k] -
S[k])``. S is computed in float64 and the row cast back to f32: in f32, S
reaches thousands over a 1,499-frame document, where one ulp (2.4e-4)
divided by a short query's length is above a 1e-5 relative tolerance.
"""

from __future__ import annotations

import contextlib
from typing import Iterator

import torch

INF = 1e9


@contextlib.contextmanager
def ieee_matmul() -> Iterator[None]:
    """f32 matmuls in full f32 (TF32 off) inside the block."""
    saved = torch.backends.cuda.matmul.allow_tf32
    torch.backends.cuda.matmul.allow_tf32 = False
    try:
        yield
    finally:
        torch.backends.cuda.matmul.allow_tf32 = saved


def _unit(x: torch.Tensor) -> torch.Tensor:
    return x / torch.clamp(torch.linalg.vector_norm(x, dim=-1, keepdim=True), min=1e-8)


def cosine_distance_matrix(query: torch.Tensor, doc: torch.Tensor) -> torch.Tensor:
    """[Tq, D], [Td, D] -> [Tq, Td] in [0, 2], f32 (TF32 off)."""
    with ieee_matmul():
        return 1.0 - _unit(query.float()) @ _unit(doc.float()).T


def _row_update(prev_row: torch.Tensor, cost_row: torch.Tensor) -> torch.Tensor:
    """One DP row over the last axis (module docstring)."""
    prev_shift = torch.nn.functional.pad(prev_row[..., :-1], (1, 0), value=INF)
    base = cost_row + torch.minimum(prev_row, prev_shift)
    s = torch.cumsum(cost_row.double(), dim=-1)
    return (s + torch.cummin(base.double() - s, dim=-1).values).float()


def _chunk_costs(cost: torch.Tensor, query_lens: torch.Tensor,
                 doc_lens: torch.Tensor) -> torch.Tensor:
    """cost [Q, Tq, n, Td] f32 (overwritten) -> [Q, n] minimal costs of the
    last valid query row over the valid document columns, divided by the
    query's length."""
    Q, Tq, n, Td = cost.shape
    dev = cost.device
    doc_mask = torch.arange(Td, device=dev)[None, :] < doc_lens[:, None]  # [n, Td]
    cost.masked_fill_(~doc_mask[None, None], INF)
    q_idx = torch.clamp(query_lens - 1, 0, Tq - 1)[:, None, None]  # [Q, 1, 1]
    prev = cost[:, 0]
    last = prev
    for i in range(1, int(q_idx.max()) + 1):
        prev = _row_update(prev, cost[:, i])
        last = torch.where(q_idx == i, prev, last)
    best = torch.where(doc_mask[None], last, INF).min(dim=-1).values
    return best / torch.clamp(query_lens, min=1)[:, None].float()


def subsequence_dtw_cost(cost: torch.Tensor, query_len, doc_len) -> torch.Tensor:
    """Minimal average-cost subsequence alignment of a query into a doc.

    cost: [Tq, Td] padded distance matrix. Start anywhere in the doc's row
    0, end anywhere in the last valid query row; normalised by the query's
    length. Returns a 0-d f32 tensor."""
    dev = cost.device
    q = torch.as_tensor(query_len, device=dev).reshape(1)
    d = torch.as_tensor(doc_len, device=dev).reshape(1)
    return _chunk_costs(cost.float().clone()[None, :, None], q, d)[0, 0]


def qbe_scores(queries: torch.Tensor, query_lens: torch.Tensor, docs: torch.Tensor,
               doc_lens: torch.Tensor, max_gib: float = 2.0) -> torch.Tensor:
    """queries [Q, Tq, D] and docs [N, Td, D] padded, with their lengths ->
    [Q, N] f32 similarity scores (higher: a better match), on the inputs'
    device. Documents go in chunks whose f32 cost tensor [Q, Tq, n, Td']
    stays under `max_gib` GiB (at least one document a chunk)."""
    dev = queries.device
    query_lens = torch.as_tensor(query_lens, device=dev).long()
    doc_lens = torch.as_tensor(doc_lens, device=dev).long()
    Q, Tq, _ = queries.shape
    Tq = max(min(Tq, int(query_lens.max())), 1)
    q = _unit(queries[:, :Tq].float())
    d_all = _unit(docs.float())
    lens = doc_lens.tolist()
    out = []
    start = 0
    while start < len(lens):
        # the largest chunk from `start` whose cost tensor fits
        stop, Td = start + 1, max(lens[start], 1)
        while stop < len(lens):
            Td_next = max(Td, lens[stop])
            if Q * Tq * (stop + 1 - start) * Td_next * 4 > max_gib * 2**30:
                break
            stop, Td = stop + 1, Td_next
        d = d_all[start:stop, :Td]
        with ieee_matmul():
            sim = (q.reshape(Q * Tq, -1) @ d.reshape(-1, d.shape[-1]).T)
        cost = sim.view(Q, Tq, stop - start, Td).neg_().add_(1.0)
        out.append(_chunk_costs(cost, query_lens, doc_lens[start:stop]))
        del cost, sim
        start = stop
    return -torch.cat(out, dim=1)
