"""s3prl_tpu_torch.ops.quant and the load-time int8 cache vs s3prl_tpu.ops.quant (CPU).

The same numpy inputs go through both packages' quantizers. Codes and
scales must agree bit for bit: both clamp at 1e-8, divide by the scale and
round half to even. `int8_matmul` sums exactly in int32 and then runs the
same f32 operations in the same order, so it is held at atol 1e-6 (it
agrees exactly in practice). Every test runs with the JAX package's default
knobs (the `S3PRL_*` variables that change its serving path are removed).
"""

from pathlib import Path

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from s3prl_tpu.ops import quant as jax_quant
from s3prl_tpu_torch.models.wav2vec2 import Wav2Vec2Config
from s3prl_tpu_torch.ops import quant
from s3prl_tpu_torch.upstream.registry import _trunk_upstream

JAX_KNOBS = ("S3PRL_GELU", "S3PRL_STATIC_ACT", "S3PRL_INT8_AV", "S3PRL_ATTN_BLOCK")
TINY = Wav2Vec2Config(
    extractor_mode="layer_norm", conv_feature_layers=((64, 10, 5), (64, 3, 2), (64, 2, 2)),
    encoder_layers=2, encoder_embed_dim=128, encoder_ffn_embed_dim=256,
    encoder_attention_heads=4, conv_pos=16, conv_pos_groups=4, layer_norm_first=True,
    normalize=True)


@pytest.fixture(autouse=True)
def _jax_defaults(monkeypatch):
    for knob in JAX_KNOBS:
        monkeypatch.delenv(knob, raising=False)


def _pair(a, dtype):
    """One numpy array as a JAX array and a torch tensor of one dtype."""
    jdt, tdt = {"f32": (jnp.float32, torch.float32),
                "bf16": (jnp.bfloat16, torch.bfloat16)}[dtype]
    return jnp.asarray(a, jdt), torch.from_numpy(np.asarray(a, np.float32)).to(tdt)


def _equal(got, want):
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))


@pytest.mark.parametrize("dtype", ["f32", "bf16"])
def test_quantize_rows_and_cols_match_jax_bit_for_bit(dtype):
    rng = np.random.RandomState(0)
    a = rng.randn(3, 64, 96) * np.exp(rng.randn(3, 64, 1))  # rows of many scales
    ja, ta = _pair(a, dtype)
    for got, want in zip(quant.quantize_rows(ta), jax_quant.quantize_rows(ja)):
        _equal(got, want)
    ja, ta = _pair(a[0], dtype)
    for got, want in zip(quant.quantize_cols(ta), jax_quant.quantize_cols(ja)):
        _equal(got, want)


def test_quantize_rounds_ties_half_to_even():
    """x / s = +-2.5, +-3.5, +-0.5, 1.5 exactly (s = 1): half to even, as
    torch.round and jnp.round; zero rows keep the 1e-8 floor."""
    a = np.array([[127, 2.5, -2.5, 3.5, -3.5, 0.5, -0.5, 1.5],
                  [0, 0, 0, 0, 0, 0, 0, 0]], np.float32)
    ja, ta = _pair(a, "f32")
    q, s = quant.quantize_rows(ta)
    assert q[0].tolist() == [127, 2, -2, 4, -4, 0, 0, 2]
    assert q[0].tolist() == torch.round(ta[0]).to(torch.int8).tolist()
    assert q[1].tolist() == [0] * 8 and float(s[1, 0]) == np.float32(1e-8) / np.float32(127)
    jq, js = jax_quant.quantize_rows(ja)
    _equal(q, jq)
    _equal(s, js)


@pytest.mark.parametrize("out_dtype", ["f32", "bf16"])
def test_int8_matmul_matches_jax(out_dtype):
    rng = np.random.RandomState(1)
    x = rng.randn(5, 7, 96).astype(np.float32)
    w = (rng.randn(96, 48) * 0.1).astype(np.float32)  # JAX [K, N]
    b = (rng.randn(48) * 0.01).astype(np.float32)
    jx, tx = _pair(x, out_dtype)
    want = jax_quant.int8_matmul(jx, jnp.asarray(w), jnp.asarray(b))
    t = torch.from_numpy
    for weight in (t(w.T.copy()), quant.as_quantized_cols(t(w.T.copy()))):
        got = quant.int8_matmul(tx, weight, t(b))
        assert got.dtype == tx.dtype and tuple(got.shape) == (5, 7, 48)
        np.testing.assert_allclose(got.float().numpy(),
                                   np.asarray(jnp.asarray(want, jnp.float32)), atol=1e-6, rtol=0)


@pytest.mark.parametrize("M,K,N", [(3, 20, 12), (17, 16, 8), (40, 96, 48)])
def test_int_mm_is_exact_at_any_shape(M, K, N):
    """Rows padded to 17 and K, N to multiples of 8 (torch._int_mm's CUDA
    limits) leave the int32 sums exact."""
    rng = np.random.RandomState(2)
    a = torch.from_numpy(rng.randint(-127, 128, (M, K)).astype(np.int8))
    w = torch.from_numpy(rng.randint(-127, 128, (N, K)).astype(np.int8))
    got = quant.int_mm(a, w)
    assert got.dtype == torch.int32 and tuple(got.shape) == (M, N)
    assert torch.equal(got.long(), a.long() @ w.long().t())


def test_qcache_equals_jax_quantize_cols_of_the_f32_weights():
    """The load-time cache quantizes the f32 weights (the JAX params' dtype),
    not their bf16 roundings, which give other codes and scales."""
    up = _trunk_upstream("tiny", TINY, dtype=torch.bfloat16, flash=True, quantize=True, seed=4,
                         device="cpu")
    differs = False
    for layer in up.model.encoder.layers:
        attn = layer.self_attn
        for mod, name, w in ((attn, "qkv", attn.qkv_weight),
                             (attn, "out_proj", attn.out_proj.weight),
                             (layer, "fc1", layer.fc1.weight), (layer, "fc2", layer.fc2.weight)):
            assert w.dtype == torch.float32
            codes, scales = mod.qpair(name)
            kernel = w.detach().numpy().T  # the JAX [K, N] kernel
            want_q, want_s = jax_quant.quantize_cols(jnp.asarray(kernel))
            _equal(codes.t(), want_q)
            _equal(scales, want_s)
            bf_q, bf_s = jax_quant.quantize_cols(jnp.asarray(kernel, jnp.bfloat16))
            differs |= not (np.array_equal(codes.t().numpy(), np.asarray(bf_q))
                            and np.array_equal(scales.numpy(), np.asarray(bf_s)))
    assert differs


def test_qcache_follows_load_state_dict():
    up = _trunk_upstream("tiny", TINY, quantize=True, seed=5, device="cpu")
    layer = up.model.encoder.layers[1]
    sd = up.model.state_dict()
    sd["encoder.layers.1.fc2.weight"] = sd["encoder.layers.1.fc2.weight"] * 2
    up.model.load_state_dict(sd)
    codes, scales = layer.qpair("fc2")
    want_q, want_s = quant.as_quantized_cols(layer.fc2.weight.detach())
    assert torch.equal(codes, want_q) and torch.equal(scales, want_s)


def test_port_reads_no_s3prl_variable():
    root = Path(__file__).resolve().parents[1] / "s3prl_tpu_torch"
    readers = [p.name for p in root.rglob("*.py") if "S3PRL_" in p.read_text()]
    assert not readers, readers
