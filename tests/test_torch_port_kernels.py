"""s3prl_tpu_torch kernel modules vs the JAX package's Pallas kernels (CPU).

The same numpy inputs go through the JAX function in Pallas interpret mode
and through the port's wrapper, which on CPU tensors runs the kernel's plain
PyTorch version. Weights cross in torch layout (the transposes of the JAX
kernels' arguments). Tolerances: f32 at atol 1e-4 (sum order); bf16 at
cosine > 0.9995 over valid rows, the bar of tests/test_kernels.py for the
Pallas kernels against f32 math. The int8 kernels (K1, K2) take the same
cosine bar plus every element within INT8_ATOL = 6.25e-2, two bf16 steps at
|v| in [4, 8): XLA's CPU lowering of the interpreted kernel and the plain
version round bf16 intermediates and LN sums in other places, which can
move a value across a .5 tie and so one int8 code by one step. Every test
runs with the JAX package's default knobs (the `S3PRL_*` variables that
change its serving path are removed).
"""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

import s3prl_tpu.kernels.ffn as jax_ffn
from s3prl_tpu.kernels.conv_frontend import conv0_ln_gelu as jax_conv0
from s3prl_tpu.kernels.flash_attention import (
    fused_attention_block as jax_int8_attn_block,
    fused_attention_block_bf16 as jax_attn_block)
from s3prl_tpu.ops import masking as jax_masking
from s3prl_tpu_torch.kernels import _build, wrappers
from s3prl_tpu_torch.kernels import ffn as port_ffn
from s3prl_tpu_torch.kernels.conv_frontend import conv0_ln_gelu
from s3prl_tpu_torch.kernels.ffn import fused_bf16_ffn, fused_int8_ffn
from s3prl_tpu_torch.kernels.flash_attention import (
    fused_attention_block, fused_attention_block_bf16)
from s3prl_tpu_torch.ops import masking
from s3prl_tpu_torch.ops.quant import as_quantized_cols

INT8_ATOL = 6.25e-2
JAX_KNOBS = ("S3PRL_GELU", "S3PRL_STATIC_ACT", "S3PRL_INT8_AV", "S3PRL_ATTN_BLOCK")


@pytest.fixture(autouse=True)
def _jax_defaults(monkeypatch):
    for knob in JAX_KNOBS:
        monkeypatch.delenv(knob, raising=False)


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
    assert {"common.cuh", "hopper.cuh", "conv0_ln_gelu.cu", "layernorm.cu", "gemm_bf16.cu",
            "gated_attention.cu", "gemm_s8.cu", "quant_rows.cu"} <= names
    assert "attention.cu" not in names  # K11's attention runs on gated_attention.cu
    assert len(_build._digest()) == 16


def test_build_declares_every_c_entry():
    """Every `extern "C"` entry of the sources has its ctypes argument types in
    `_build.SIGNATURES` (an undeclared pointer would pass as a 32-bit int), and
    every declared name is an entry; `s3_error_string` is typed apart."""
    import re

    entries = set()
    for path in _build.sources():
        entries |= set(re.findall(r'extern "C"[^(]*?\b(s3_\w+)\(', path.read_text()))
    assert "s3_conv0_occupancy" in entries
    assert entries == set(_build.SIGNATURES) | {"s3_error_string"}


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


@pytest.mark.parametrize("dtype", ["f32", "bf16"])
def test_conv0_ln_gelu_tanh_matches_pallas(dtype):
    """K3's tanh mode (the int8 serving path's GELU)."""
    rng = np.random.RandomState(7)
    B, T, C = 2, 3203, 64
    wav = rng.randn(B, T).astype(np.float32)
    kernel = (rng.randn(10, 1, C) / np.sqrt(10)).astype(np.float32)
    g = (1.0 + 0.1 * rng.randn(C)).astype(np.float32)
    b = (0.1 * rng.randn(C)).astype(np.float32)
    jdt, tdt = (jnp.float32, torch.float32) if dtype == "f32" else (jnp.bfloat16, torch.bfloat16)
    want = jax_conv0(jnp.asarray(wav, jdt), jnp.asarray(kernel), jnp.asarray(g),
                     jnp.asarray(b), interpret=True, gelu_mode="tanh")
    got = conv0_ln_gelu(torch.from_numpy(wav).to(tdt),
                        torch.from_numpy(kernel.transpose(2, 1, 0).copy()).to(tdt),
                        torch.from_numpy(g), torch.from_numpy(b), gelu_mode="tanh")
    assert got.dtype == tdt and tuple(got.shape) == want.shape
    if dtype == "f32":
        np.testing.assert_allclose(_np(got), _np(want), atol=1e-4, rtol=0)
    else:
        assert _cos(_np(got), _np(want)) > 0.9995
    erf = conv0_ln_gelu(torch.from_numpy(wav).to(tdt),
                        torch.from_numpy(kernel.transpose(2, 1, 0).copy()).to(tdt),
                        torch.from_numpy(g), torch.from_numpy(b))
    assert not torch.equal(erf, got)  # the mode reaches the computation


@pytest.mark.parametrize("postnorm", [False, True], ids=["preln", "postnorm"])
def test_int8_attention_block_matches_pallas(postnorm):
    """K1 (dynamic scales) against the Pallas kernel in interpret mode, the
    weights crossing as the load-time (codes, scales) pairs."""
    B, T, C, H = 3, 77, 128, 4
    x, wq, bq, wo, bo, g, be = _attn_inputs(2, B, T, C)
    kv_lens = np.array([77, 41, 1], np.int32)
    jx, tx = _bf16_pair(x)
    want = jax_int8_attn_block(jx, jnp.asarray(wq), jnp.asarray(bq),
                               (jnp.asarray(g), jnp.asarray(be)), jnp.asarray(wo),
                               jnp.asarray(bo), jnp.asarray(kv_lens), H,
                               postnorm=postnorm, interpret=True)
    t = torch.from_numpy
    got = fused_attention_block(
        tx, as_quantized_cols(t(wq.T.copy())), t(bq), (t(g), t(be)),
        as_quantized_cols(t(wo.T.copy())), t(bo), t(kv_lens), H, postnorm=postnorm)
    assert got.dtype == torch.bfloat16 and tuple(got.shape) == (B, T, C)
    for i, n in enumerate(kv_lens):
        assert _cos(_np(got)[i, :n], _np(want)[i, :n]) > 0.9995, i
    np.testing.assert_allclose(_np(got), _np(want), atol=INT8_ATOL, rtol=0)


@pytest.mark.parametrize("postnorm", [False, True], ids=["preln", "postnorm"])
def test_int8_attention_block_matches_pallas_at_c768(postnorm):
    """K1 at HuBERT-Base's width (C = 768, 12 heads; postnorm is its block
    order), B * T = 2 x 45 rows: the row width the card's panel kernel
    holds besides 1,024, through the plain version it is checked against."""
    B, T, C, H = 2, 45, 768, 12
    x, wq, bq, wo, bo, g, be = _attn_inputs(4, B, T, C)
    kv_lens = np.array([45, 17], np.int32)
    jx, tx = _bf16_pair(x)
    want = jax_int8_attn_block(jx, jnp.asarray(wq), jnp.asarray(bq),
                               (jnp.asarray(g), jnp.asarray(be)), jnp.asarray(wo),
                               jnp.asarray(bo), jnp.asarray(kv_lens), H,
                               postnorm=postnorm, interpret=True)
    t = torch.from_numpy
    got = fused_attention_block(
        tx, as_quantized_cols(t(wq.T.copy())), t(bq), (t(g), t(be)),
        as_quantized_cols(t(wo.T.copy())), t(bo), t(kv_lens), H, postnorm=postnorm)
    assert got.dtype == torch.bfloat16 and tuple(got.shape) == (B, T, C)
    for i, n in enumerate(kv_lens):
        assert _cos(_np(got)[i, :n], _np(want)[i, :n]) > 0.9995, i
    np.testing.assert_allclose(_np(got), _np(want), atol=INT8_ATOL, rtol=0)


def test_int8_attention_block_refuses_static_scales():
    x, wq, bq, wo, bo, g, be = _attn_inputs(2, 1, 8, 128)
    t = torch.from_numpy
    with pytest.raises(NotImplementedError, match="static"):
        fused_attention_block(t(x).bfloat16(), t(wq.T.copy()), t(bq), (t(g), t(be)),
                              t(wo.T.copy()), t(bo), torch.tensor([8], dtype=torch.int32), 4,
                              act_scales=torch.ones(2))


def _ffn_inputs(seed, B, T, C, F):
    rng = np.random.RandomState(seed)
    arrs = (rng.randn(B, T, C) * 0.5, rng.randn(C, F) / np.sqrt(C), rng.randn(F) * 0.02,
            rng.randn(F, C) / np.sqrt(F), rng.randn(C) * 0.02, 1.0 + 0.1 * rng.randn(C),
            0.1 * rng.randn(C))
    return [np.asarray(a, np.float32) for a in arrs]


def _int8_ffn_pair(inputs, ln, residual, postnorm):
    x, w1, b1, w2, b2, g, be = inputs
    jx, tx = _bf16_pair(x)
    want = jax_ffn.fused_int8_ffn(
        jx, jnp.asarray(w1), jnp.asarray(b1), jnp.asarray(w2), jnp.asarray(b2),
        ln=(jnp.asarray(g), jnp.asarray(be)) if ln else None, residual=residual,
        postnorm=postnorm, interpret=True)
    t = torch.from_numpy
    got = fused_int8_ffn(
        tx, as_quantized_cols(t(w1.T.copy())), t(b1), as_quantized_cols(t(w2.T.copy())),
        t(b2), ln=(t(g), t(be)) if ln else None, residual=residual, postnorm=postnorm)
    assert got.dtype == torch.bfloat16 and tuple(got.shape) == tuple(x.shape)
    return _np(got), _np(want)


@pytest.mark.parametrize("ln,residual,postnorm", [
    (True, True, False), (False, False, False), (True, False, False),
    (False, True, False), (True, True, True)],
    ids=["ln-res", "plain", "ln", "res", "postnorm"])
def test_int8_ffn_matches_pallas(ln, residual, postnorm):
    """K2 in every flag combination, F=256: one chunk."""
    got, want = _int8_ffn_pair(_ffn_inputs(3, 2, 61, 128, 256), ln, residual, postnorm)
    assert _cos(got, want) > 0.9995
    np.testing.assert_allclose(got, want, atol=INT8_ATOL, rtol=0)


def test_int8_ffn_matches_pallas_two_chunks():
    """F=4096 (HuBERT-Large's width) at C=64: two 2048-wide chunks, each
    with its own per-row requant scale, summed in f32."""
    assert port_ffn._ffn_chunk_bounds(4096) == ((0, 2048), (2048, 4096))
    got, want = _int8_ffn_pair(_ffn_inputs(4, 1, 7, 64, 4096), True, True, False)
    assert _cos(got, want) > 0.9995
    np.testing.assert_allclose(got, want, atol=INT8_ATOL, rtol=0)


@pytest.mark.parametrize("ln,residual", [(True, True), (False, False)], ids=["ln-res", "plain"])
def test_int8_ffn_matches_pallas_partial_chunk(ln, residual):
    """F=3200 (the JAX package's tests/test_quant.py:237-256): one full
    2048-wide chunk and a 1152-wide one, each with its own per-row requant
    scale; the partial chunk's columns are not dropped."""
    assert port_ffn._ffn_chunk_bounds(3200) == ((0, 2048), (2048, 3200))
    got, want = _int8_ffn_pair(_ffn_inputs(5, 1, 5, 128, 3200), ln, residual, False)
    assert _cos(got, want) > 0.9995
    np.testing.assert_allclose(got, want, atol=INT8_ATOL, rtol=0)


@pytest.mark.parametrize("ffn", [256, 3072, 3200, 4096, 5120])
def test_ffn_chunk_rule_matches_jax(ffn):
    assert port_ffn._chunk_for(ffn) == jax_ffn._chunk_for(ffn)
    assert port_ffn._ffn_chunk_bounds(ffn) == jax_ffn._ffn_chunk_bounds(ffn)


def test_int8_wrappers_on_cpu_run_the_plain_versions_without_a_build():
    before = [w.launches for w in wrappers()]
    x, wq, bq, wo, bo, g, be = _attn_inputs(5, 1, 9, 128)
    t = torch.from_numpy
    fused_attention_block(t(x).bfloat16(), t(wq.T.copy()), t(bq), (t(g), t(be)),
                          t(wo.T.copy()), t(bo), torch.tensor([9], dtype=torch.int32), 2)
    x, w1, b1, w2, b2, g, be = _ffn_inputs(6, 1, 5, 128, 256)
    fused_int8_ffn(t(x).bfloat16(), t(w1.T.copy()), t(b1), t(w2.T.copy()), t(b2))
    assert [w.launches for w in wrappers()] == before
    assert _build.library.cache_info().currsize == 0
