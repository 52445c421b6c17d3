"""Pretraining's ops in s3prl_tpu_torch vs s3prl_tpu (CPU): the span masks
(`compute_mask_indices`), the MAM masks (`mam_mask`) and the SpecAugment
bands equal JAX's exactly given JAX's uniforms (the draws of its keys,
split as its functions split them); `kmeans_fit_from` from JAX's initial
centroids within 1e-5 of JAX's `kmeans_fit`, with equal assignments; the
pure-Python msgpack reader against flax's on the trees flax writes.
"""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp
from flax import serialization

from s3prl_tpu.nn.specaug import _band_mask as jax_band_mask
from s3prl_tpu.ops.kmeans import kmeans_assign as jax_assign
from s3prl_tpu.ops.kmeans import kmeans_fit as jax_fit
from s3prl_tpu.ops.mam import mam_mask as jax_mam_mask
from s3prl_tpu.ops.masking import compute_mask_indices as jax_mask_indices
from s3prl_tpu_torch.nn.specaug import band_mask
from s3prl_tpu_torch.ops.kmeans import (kmeans_assign, kmeans_fit, kmeans_fit_from,
                                        kmeans_inertia, kmeans_init)
from s3prl_tpu_torch.ops.mam import mam_mask, mam_mask_from_uniforms, mam_spans
from s3prl_tpu_torch.ops.masking import (compute_mask_indices, mask_indices_from_uniforms,
                                         max_mask_spans)
from s3prl_tpu_torch.util.msgpack import msgpack_restore

T = torch.from_numpy


@pytest.mark.parametrize("T_,lens,prob,length", [
    (50, (50, 23, 5, 0), 0.8, 10),  # HuBERT's defaults; rows shorter than a span, empty
    (49, (49, 30, 11), 0.65, 10),  # data2vec's
    (37, (37, 20), 0.65, 4),  # the Example recipes'
    (64, None, 0.5, 3),  # no padding mask
])
def test_compute_mask_indices_given_jax_uniforms(T_, lens, prob, length):
    B = 4 if lens is None else len(lens)
    pad = None if lens is None else np.arange(T_)[None] >= np.asarray(lens)[:, None]
    for seed in range(3):
        key = jax.random.key(seed)
        want = np.asarray(jax_mask_indices(key, (B, T_), None if pad is None else jnp.asarray(pad),
                                           prob, length))
        k1, k2, _ = jax.random.split(key, 3)
        S = max_mask_spans(T_, prob, length)
        uniforms = (T(np.asarray(jax.random.uniform(k1, (B,)))),
                    T(np.asarray(jax.random.uniform(k2, (B, S)))))
        got = mask_indices_from_uniforms(uniforms, (B, T_), None if pad is None else T(pad),
                                         prob, length)
        assert np.array_equal(got.numpy(), want), seed
    # the draw: masks inside the rows, the same generator seed the same mask
    gen = lambda: torch.Generator().manual_seed(0)  # noqa: E731
    a = compute_mask_indices(gen(), (B, T_), None if pad is None else T(pad), prob, length)
    assert torch.equal(a, compute_mask_indices(gen(), (B, T_), None if pad is None else T(pad),
                                               prob, length))
    if pad is not None:
        assert not (a & T(pad)).any()


def _jax_mam_uniforms(key, B, T_, prop, cons):
    k_span, k_mode, k_rand, k_freq, k_fwidth = jax.random.split(key, 5)
    S = mam_spans(T_, prop, cons)
    u = jax.random.uniform
    return {"span": u(k_span, (B, S)), "mode": u(k_mode, (B, S, 1)), "rand": u(k_rand, (B, T_)),
            "freq": u(k_freq, (B, 1)), "fwidth": u(k_fwidth, (B, 1))}


@pytest.mark.parametrize("freq", [0.0, 0.2])
def test_mam_mask_given_jax_uniforms(freq):
    rng = np.random.RandomState(0)
    B, T_, D = 4, 60, 80
    feats = rng.randn(B, T_, D).astype(np.float32)
    lens = np.asarray([60, 31, 3, 1], np.int32)
    kw = dict(mask_proportion=0.15, mask_consecutive=7, mask_frequency=freq)
    for seed in range(3):
        key = jax.random.key(seed)
        want, want_label = jax_mam_mask(key, jnp.asarray(feats), jnp.asarray(lens), **kw)
        u = {k: T(np.asarray(v)) for k, v in _jax_mam_uniforms(key, B, T_, 0.15, 7).items()}
        got, label = mam_mask_from_uniforms(u, T(feats), T(lens), **kw)
        assert np.array_equal(label.numpy(), np.asarray(want_label))
        assert np.array_equal(got.numpy(), np.asarray(want)), seed
    got, label = mam_mask(torch.Generator().manual_seed(1), T(feats), T(lens), **kw)
    assert label.any() and not label[3, 1:].any() and (got != T(feats)).any()


def test_spec_augment_bands_given_jax_draws():
    for B, L, M, W, seed in [(3, 80, 2, 27, 0), (2, 240, 2, 27, 1), (4, 57, 2, 100, 2)]:
        key = jax.random.key(seed)
        want = np.asarray(jax_band_mask(key, B, L, M, W))
        k1, k2 = jax.random.split(key)
        widths = jax.random.randint(k1, (B, M), 0, W + 1)
        starts = (jax.random.uniform(k2, (B, M)) * jnp.maximum(L - widths, 1).astype(jnp.float32)
                  ).astype(jnp.int32)
        got = band_mask(T(np.asarray(starts)).long(), T(np.asarray(widths)).long(), L)
        assert np.array_equal(got.numpy(), want)


def test_kmeans_from_jax_init():
    rng = np.random.RandomState(0)
    centers = rng.randn(6, 8).astype(np.float32) * 4
    feats = (centers[rng.randint(0, 6, 500)] + rng.randn(500, 8)).astype(np.float32)
    key = jax.random.key(3)
    want = np.asarray(jax_fit(key, jnp.asarray(feats), 6, iters=12))
    init = feats[np.asarray(jax.random.permutation(key, 500))[:6]]
    got = kmeans_fit_from(T(feats), T(init), iters=12)
    np.testing.assert_allclose(got.numpy(), want, atol=1e-5, rtol=0)
    assert np.array_equal(kmeans_assign(T(feats), got).numpy(),
                          np.asarray(jax_assign(jnp.asarray(feats), jnp.asarray(want))))
    # an empty cluster keeps its centroid: two tight blobs, four clusters
    blobs = np.concatenate([rng.randn(50, 4), rng.randn(50, 4) + 20]).astype(np.float32)
    far = np.full((1, 4), 1e3, np.float32)
    c = kmeans_fit_from(T(blobs), T(np.concatenate([blobs[:1], blobs[-1:], blobs[1:2], far])), 5)
    assert torch.equal(c[3], T(far[0])) and bool(torch.isfinite(c).all())
    init = kmeans_init(torch.Generator().manual_seed(0), T(feats), 6)
    c = kmeans_fit(torch.Generator().manual_seed(0), T(feats), 6, iters=12)
    assert init.shape == (6, 8) and torch.equal(c, kmeans_fit_from(T(feats), init, 12))
    assert kmeans_inertia(T(feats), c) < kmeans_inertia(T(feats), init)


def test_msgpack_reader_against_flax(monkeypatch):
    rng = np.random.RandomState(0)
    tree = {"params": {
        "dense": {"kernel": rng.randn(3, 5).astype(np.float32), "bias": np.zeros(5, np.float32)},
        "bf16": jnp.asarray(rng.randn(4), jnp.bfloat16),
        "ints": np.arange(7, dtype=np.int32), "i64": np.arange(3, dtype=np.int64) - 2 ** 40,
        "empty": np.zeros((0, 3), np.float32), "scalar": np.ones((), np.float32),
        "f16": rng.randn(2, 2).astype(np.float16)},
        "meta": {"name": "x" * 40, "n": 2 ** 40, "neg": -3, "negbig": -70000, "f": 0.25,
                 "on": True, "off": False, "none": None, "long": "y" * 70000}}
    for data in (serialization.to_bytes(tree), serialization.msgpack_serialize(
            {"layers": {str(i): rng.randn(20).astype(np.float32) for i in range(20)}})):
        want = serialization.msgpack_restore(data)
        got = msgpack_restore(data)
        flat_w = jax.tree_util.tree_flatten_with_path(want)[0]
        flat_g = jax.tree_util.tree_flatten_with_path(got)[0]
        assert [p for p, _ in flat_w] == [p for p, _ in flat_g]
        for (_, w), (_, g) in zip(flat_w, flat_g):
            if isinstance(g, torch.Tensor):
                assert g.dtype == (torch.bfloat16 if str(w.dtype) == "bfloat16"
                                   else torch.from_numpy(np.asarray(w)).dtype)
                assert np.array_equal(g.float().numpy(), np.asarray(w, np.float32))
                assert tuple(g.shape) == np.shape(w)
            else:
                assert g == w
    # flax's chunked arrays (above MAX_CHUNK_SIZE bytes)
    monkeypatch.setattr(serialization, "MAX_CHUNK_SIZE", 64)
    big = rng.randn(10, 9).astype(np.float32)
    got = msgpack_restore(serialization.msgpack_serialize({"w": big}))
    assert np.array_equal(got["w"].numpy(), big)
    # what flax writes of a numpy scalar (extension 3) and truncated data raise
    with pytest.raises(ValueError, match="extension type 3"):
        msgpack_restore(serialization.to_bytes({"s": np.float32(1.0)}))
    with pytest.raises(ValueError, match="truncated"):
        msgpack_restore(serialization.to_bytes(tree)[:-5])
