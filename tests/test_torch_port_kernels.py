"""s3prl_tpu_torch kernel modules vs the JAX package's Pallas kernels (CPU).

The same numpy inputs go through the JAX function in Pallas interpret mode
and through the port's wrapper, which on CPU tensors runs the kernel's plain
PyTorch version. Weights cross in torch layout (the transposes of the JAX
kernels' arguments). Tolerances: f32 at atol 1e-4 (sum order); bf16 at
cosine > 0.9995 over valid rows, the bar of tests/test_kernels.py for the
Pallas kernels against f32 math.
"""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

import s3prl_tpu.kernels.ffn as jax_ffn
from s3prl_tpu.kernels.conv_frontend import conv0_ln_gelu as jax_conv0
from s3prl_tpu.kernels.flash_attention import (
    fused_attention_block_bf16 as jax_attn_block)
from s3prl_tpu.ops import masking as jax_masking
from s3prl_tpu_torch.kernels import _build, wrappers
from s3prl_tpu_torch.kernels.conv_frontend import conv0_ln_gelu
from s3prl_tpu_torch.kernels.ffn import fused_bf16_ffn
from s3prl_tpu_torch.kernels.flash_attention import fused_attention_block_bf16
from s3prl_tpu_torch.ops import masking


def _cos(a, b):
    a = np.asarray(a, np.float64).ravel()
    b = np.asarray(b, np.float64).ravel()
    return a @ b / (np.linalg.norm(a) * np.linalg.norm(b))


def _np(x):
    return np.asarray(x.float() if isinstance(x, torch.Tensor) else jnp.asarray(x, jnp.float32))


def _bf16_pair(a):
    """One numpy array as a JAX bf16 array and a torch bf16 tensor."""
    a = np.asarray(a, np.float32)
    return jnp.asarray(a, jnp.bfloat16), torch.from_numpy(a).to(torch.bfloat16)


@pytest.mark.parametrize("dtype", ["f32", "bf16"])
def test_conv0_ln_gelu_matches_pallas(dtype):
    rng = np.random.RandomState(0)
    B, T, C = 2, 3203, 64
    wav = rng.randn(B, T).astype(np.float32)
    kernel = (rng.randn(10, 1, C) / np.sqrt(10)).astype(np.float32)  # JAX [k, 1, C]
    g = (1.0 + 0.1 * rng.randn(C)).astype(np.float32)
    b = (0.1 * rng.randn(C)).astype(np.float32)
    jdt, tdt = (jnp.float32, torch.float32) if dtype == "f32" else (jnp.bfloat16, torch.bfloat16)
    want = jax_conv0(jnp.asarray(wav, jdt), jnp.asarray(kernel), jnp.asarray(g),
                     jnp.asarray(b), interpret=True)
    got = conv0_ln_gelu(torch.from_numpy(wav).to(tdt),
                        torch.from_numpy(kernel.transpose(2, 1, 0).copy()).to(tdt),
                        torch.from_numpy(g), torch.from_numpy(b))
    assert got.dtype == tdt and tuple(got.shape) == want.shape == (B, (T - 10) // 5 + 1, C)
    if dtype == "f32":
        np.testing.assert_allclose(_np(got), _np(want), atol=1e-4, rtol=0)
    else:
        assert _cos(_np(got), _np(want)) > 0.9995


def _attn_inputs(seed, B, T, C):
    rng = np.random.RandomState(seed)
    x = rng.randn(B, T, C) * 0.5
    wq = rng.randn(C, 3 * C) / np.sqrt(C)
    bq = rng.randn(3 * C) * 0.02
    wo = rng.randn(C, C) / np.sqrt(C)
    bo = rng.randn(C) * 0.02
    g = 1.0 + 0.1 * rng.randn(C)
    be = 0.1 * rng.randn(C)
    return [np.asarray(a, np.float32) for a in (x, wq, bq, wo, bo, g, be)]


@pytest.mark.parametrize("postnorm", [False, True], ids=["preln", "postnorm"])
def test_attention_block_matches_pallas(postnorm):
    B, T, C, H = 3, 77, 128, 4
    x, wq, bq, wo, bo, g, be = _attn_inputs(2, B, T, C)
    kv_lens = np.array([77, 41, 1], np.int32)
    jx, tx = _bf16_pair(x)
    want = jax_attn_block(jx, jnp.asarray(wq), jnp.asarray(bq),
                          (jnp.asarray(g), jnp.asarray(be)), jnp.asarray(wo),
                          jnp.asarray(bo), jnp.asarray(kv_lens), H,
                          postnorm=postnorm, interpret=True)
    t = torch.from_numpy
    got = fused_attention_block_bf16(
        tx, t(wq.T.copy()).to(torch.bfloat16), t(bq), (t(g), t(be)),
        t(wo.T.copy()).to(torch.bfloat16), t(bo), t(kv_lens), H, postnorm=postnorm)
    assert got.dtype == torch.bfloat16 and tuple(got.shape) == (B, T, C)
    for i, n in enumerate(kv_lens):
        assert _cos(_np(got)[i, :n], _np(want)[i, :n]) > 0.9995, i


@pytest.mark.parametrize("ln,residual,postnorm", [
    (True, True, False), (False, False, False), (True, True, True)],
    ids=["ln-res", "plain", "postnorm"])
def test_ffn_matches_pallas_multi_panel(monkeypatch, ln, residual, postnorm):
    """BF16_CHUNK=128 makes the Pallas kernel sum four FFN panels."""
    monkeypatch.setattr(jax_ffn, "BF16_CHUNK", 128)
    rng = np.random.RandomState(3)
    B, T, C, F = 2, 61, 128, 512
    x = (rng.randn(B, T, C) * 0.5).astype(np.float32)
    w1 = (rng.randn(C, F) / np.sqrt(C)).astype(np.float32)
    b1 = (rng.randn(F) * 0.02).astype(np.float32)
    w2 = (rng.randn(F, C) / np.sqrt(F)).astype(np.float32)
    b2 = (rng.randn(C) * 0.02).astype(np.float32)
    g = (1.0 + 0.1 * rng.randn(C)).astype(np.float32)
    be = (0.1 * rng.randn(C)).astype(np.float32)
    jx, tx = _bf16_pair(x)
    want = jax_ffn.fused_bf16_ffn(
        jx, jnp.asarray(w1), jnp.asarray(b1), jnp.asarray(w2), jnp.asarray(b2),
        ln=(jnp.asarray(g), jnp.asarray(be)) if ln else None, residual=residual,
        postnorm=postnorm, interpret=True)
    t = torch.from_numpy
    got = fused_bf16_ffn(
        tx, t(w1.T.copy()).to(torch.bfloat16), t(b1), t(w2.T.copy()).to(torch.bfloat16),
        t(b2), ln=(t(g), t(be)) if ln else None, residual=residual, postnorm=postnorm)
    assert got.dtype == torch.bfloat16 and tuple(got.shape) == (B, T, C)
    assert _cos(_np(got), _np(want)) > 0.9995


def test_cpu_tensors_run_the_plain_versions_without_a_build():
    """CPU calls neither build the library nor count a launch."""
    before = [w.launches for w in wrappers()]
    conv0_ln_gelu(torch.randn(1, 100), torch.randn(8, 1, 10), torch.ones(8),
                  torch.zeros(8))
    fused_bf16_ffn(torch.randn(1, 4, 8).bfloat16(), torch.randn(16, 8).bfloat16(),
                   torch.zeros(16), torch.randn(8, 16).bfloat16(), torch.zeros(8))
    assert [w.launches for w in wrappers()] == before
    assert _build.library.cache_info().currsize == 0


def test_wrappers_refuse_mixed_and_unknown_devices():
    with pytest.raises(ValueError):
        conv0_ln_gelu(torch.empty(1, 100, device="meta"), torch.randn(8, 1, 10),
                      torch.ones(8), torch.zeros(8))
    with pytest.raises(ValueError):
        fused_bf16_ffn(torch.randn(1, 4, 8).bfloat16(), torch.randn(16, 8).bfloat16(),
                       torch.zeros(16), torch.randn(8, 16).bfloat16(), torch.zeros(8),
                       ln=(torch.ones(8), torch.zeros(8)), postnorm=True)


def test_build_hashes_every_source():
    names = {p.name for p in _build.sources()}
    assert {"common.cuh", "conv0_ln_gelu.cu", "layernorm.cu", "gemm_bf16.cu",
            "attention.cu"} <= names
    assert len(_build._digest()) == 16


@pytest.mark.parametrize("fn,args", [
    ("lengths_after_conv1d", (10, 5)), ("lengths_after_conv1d", (3, 2)),
    ("upstream_feat_lengths", (320,)), ("upstream_feat_lengths", (160,))])
def test_length_rules_match_jax(fn, args):
    lens = np.array([1, 2, 9, 10, 11, 319, 320, 321, 800, 160000], np.int32)
    want = np.asarray(getattr(jax_masking, fn)(jnp.asarray(lens), *args))
    got = getattr(masking, fn)(torch.from_numpy(lens).long(), *args).numpy()
    np.testing.assert_array_equal(got, want)


def test_length_mask_and_expected_len_match_jax():
    lens = np.array([0, 1, 5, 7], np.int32)
    np.testing.assert_array_equal(
        masking.length_mask(torch.from_numpy(lens), 7).numpy(),
        np.asarray(jax_masking.length_mask(jnp.asarray(lens), 7)))
    for n in (1, 319, 320, 321, 160000):
        assert masking.expected_max_feat_len(n, 320) == jax_masking.expected_max_feat_len(n, 320)
