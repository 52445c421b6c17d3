"""k-means for acoustic-unit discovery (port of s3prl_tpu/ops/kmeans.py), the
labels of HuBERT pretraining (the reference ecosystem's fairseq pipeline:
dump MFCC -> sklearn MiniBatchKMeans -> dump labels).

Lloyd's iterations in f32 on the features' device, with TF32 off on the
card: the E-step is one GEMM, ``argmax(f c^T - |c|^2 / 2)`` (the |f|^2 term
does not change the assignment), the M-step one-hot sums (a second GEMM);
an empty cluster keeps its centroid. The initial centroids are rows of a
permutation drawn from a `torch.Generator` (`kmeans_fit`), or given
(`kmeans_fit_from`, so a test can start both packages from the same ones).
"""

from __future__ import annotations

import contextlib

import torch


@contextlib.contextmanager
def _ieee_matmul():
    """f32 products in f32 (TF32 off) on the card, restored after."""
    before = torch.backends.cuda.matmul.allow_tf32
    torch.backends.cuda.matmul.allow_tf32 = False
    try:
        yield
    finally:
        torch.backends.cuda.matmul.allow_tf32 = before


def _assign(feats: torch.Tensor, centroids: torch.Tensor) -> torch.Tensor:
    """[N, D] x [K, D] -> [N] nearest centroid (kmeans.py:20-23)."""
    scores = feats @ centroids.T - 0.5 * (centroids ** 2).sum(1)
    return scores.argmax(1)


@torch.no_grad()
def kmeans_fit_from(feats: torch.Tensor, centroids: torch.Tensor, iters: int = 20) -> torch.Tensor:
    """`iters` Lloyd iterations from `centroids` [K, D] over feats [N, D]
    (f32, on one device) -> centroids [K, D] (kmeans.py:37-44)."""
    feats = feats.float()
    c = centroids.float().to(feats.device)
    K = c.shape[0]
    with _ieee_matmul():
        for _ in range(iters):
            onehot = torch.nn.functional.one_hot(_assign(feats, c), K).to(feats.dtype)
            sums = onehot.T @ feats
            counts = onehot.sum(0)[:, None]
            c = torch.where(counts > 0, sums / torch.clamp(counts, min=1), c)
    return c


def kmeans_init(generator: torch.Generator | None, feats: torch.Tensor, num_clusters: int
                ) -> torch.Tensor:
    """`num_clusters` distinct rows of feats [N, D], the head of a random
    permutation drawn on the CPU (kmeans.py:34-35)."""
    idx = torch.randperm(feats.shape[0], generator=generator)[:num_clusters]
    return feats[idx.to(feats.device)]


def kmeans_fit(generator: torch.Generator | None, feats: torch.Tensor, num_clusters: int,
               iters: int = 20) -> torch.Tensor:
    """Lloyd's k-means: feats [N, D] -> centroids [K, D] from `kmeans_init`."""
    return kmeans_fit_from(feats, kmeans_init(generator, feats, num_clusters), iters)


@torch.no_grad()
def kmeans_assign(feats: torch.Tensor, centroids: torch.Tensor) -> torch.Tensor:
    """[N, D] -> [N] int64 unit labels for fitted centroids."""
    with _ieee_matmul():
        return _assign(feats.float(), centroids.float().to(feats.device))


@torch.no_grad()
def kmeans_inertia(feats: torch.Tensor, centroids: torch.Tensor) -> float:
    """Mean squared distance to the assigned centroid (fit diagnostics)."""
    feats = feats.float()
    c = centroids.float().to(feats.device)
    return float(((feats - c[kmeans_assign(feats, c)]) ** 2).sum(1).mean())
