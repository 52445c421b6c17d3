"""The fused int8 projections of int8 serving in s3prl_tpu_torch vs s3prl_tpu (CPU).

K12 `fused_int8_linear` and K11 `gated_bias_attention_outproj`: the port's
wrappers on CPU tensors (their plain versions) against the JAX functions
with their Pallas kernels in interpret mode, on the same numpy inputs. Then
the options that route through them, the port's keywords against the JAX
package's switches: the tiny HuBERT-Large-style trunk of
`test_torch_port_slice.py` with ``full_fuse`` (S3PRL_FULL_FUSE=1) and
``qkv_fuse`` (S3PRL_QKV_FUSE=1, MAX_BLOCK_T = 64), and the tiny WavLM of
`test_torch_port_wavlm.py` with ``wavlm_fuse`` (S3PRL_WAVLM_FUSE=1). Each
model test sets the JAX switch, sends both packages down their kernel
routes (`_fused_block_available` -> True) and proves with a spy on the JAX
function and on the port's plain version that both took the fused route.
Tolerances:
- K12: f32 at atol 1e-4 (sum order only); bf16 at cosine > 0.9999; in
  both, the share of int8 codes (of the [LN](x) quantization) that differ
  from the JAX kernel's <= 1e-3 (f32 LN sums in another order can move a
  value across a .5 tie);
- K11: K9's bars (test_torch_port_wavlm.py:151-176) over valid rows: f32
  at atol 2e-5, bf16 at cosine > 0.9999. The f32 context is quantized per
  row, so a context value within ~1e-7 of a .5 tie can land one code
  apart, which moves its whole output row by one code's weight: f32 rows
  beyond 2e-5 are allowed in at most 1% of the valid rows, within 5e-3;
- the models: per-layer cosine > 0.999 over valid frames (the JAX
  package's gate for its reduced-precision paths), lengths exactly equal.
"""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

import s3prl_tpu.kernels.ffn as jax_ffn
import s3prl_tpu.kernels.flash_attention as jax_fa
import s3prl_tpu.models.transformer as jax_transformer
import s3prl_tpu_torch.kernels.ffn as port_ffn
import s3prl_tpu_torch.kernels.flash_attention as port_fa
import s3prl_tpu_torch.models.transformer as port_transformer
import s3prl_tpu_torch.models.wavlm as port_wavlm
import s3prl_tpu_torch.upstream.registry as port_registry
import test_torch_port_slice as hubert_tests
import test_torch_port_wavlm as wavlm_tests
from s3prl_tpu.kernels.conv_frontend import _quant_rows8 as jax_quant_rows
from s3prl_tpu.models.wav2vec2 import Wav2Vec2Trunk as JaxTrunk
from s3prl_tpu.models.wavlm import WavLMModel as JaxWavLM
from s3prl_tpu.models.wavlm import relative_position_buckets as jax_buckets
from s3prl_tpu.upstream.base import Upstream as JaxUpstream
from s3prl_tpu_torch import hub
from s3prl_tpu_torch.kernels._common import layer_norm_f32
from s3prl_tpu_torch.models.wav2vec2 import Wav2Vec2Trunk
from s3prl_tpu_torch.models.wavlm import WavLMModel
from s3prl_tpu_torch.ops.quant import quantize_rows
from s3prl_tpu_torch.upstream.base import Upstream
from s3prl_tpu_torch.upstream.convert import (trunk_state_dict_from_jax,
                                               wavlm_state_dict_from_jax)
from test_torch_port_slice import _batch, _cos, _jax_defaults, _layer_cosines  # noqa: F401
from test_torch_port_wavlm import _spy

SWITCHES = ("S3PRL_QKV_FUSE", "S3PRL_FULL_FUSE", "S3PRL_WAVLM_FUSE")
DTYPES = {"f32": (jnp.float32, torch.float32), "bf16": (jnp.bfloat16, torch.bfloat16)}


@pytest.fixture(autouse=True)
def _switches_off(monkeypatch):
    """Every test starts from the JAX package's defaults: all three off."""
    for name in SWITCHES:
        monkeypatch.delenv(name, raising=False)


def _np(x):
    return np.asarray(x.float() if isinstance(x, torch.Tensor) else jnp.asarray(x, jnp.float32),
                      np.float64)


# -- K12 ------------------------------------------------------------------------

@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("ln,residual", [(True, False), (False, True), (False, False),
                                         (True, True)], ids=["ln", "res", "plain", "ln-res"])
def test_k12_plain_matches_interpreted_pallas(ln, residual, dtype):
    """B * T = 519 rows (not a multiple of the Pallas kernel's 512); N = 3C
    with the LN (the QKV projection), N = C otherwise."""
    jdt, tdt = DTYPES[dtype]
    rng = np.random.RandomState(0)
    B, T, C = 3, 173, 128
    N = 3 * C if ln else C
    x = rng.randn(B, T, C).astype(np.float32) * 0.5
    w = (rng.randn(C, N) / np.sqrt(C)).astype(np.float32)  # JAX layout [C, N]
    b = (rng.randn(N) * 0.02).astype(np.float32)
    g, be = (1 + 0.1 * rng.randn(C)).astype(np.float32), (0.1 * rng.randn(C)).astype(np.float32)
    res = rng.randn(B, T, N).astype(np.float32) * 0.5
    t = torch.from_numpy
    want = jax_ffn.fused_int8_linear(
        jnp.asarray(x, jdt), jnp.asarray(w), jnp.asarray(b),
        ln=(jnp.asarray(g), jnp.asarray(be)) if ln else None,
        residual=jnp.asarray(res, jdt) if residual else None, interpret=True)
    got = port_ffn.fused_int8_linear(
        t(x).to(tdt), t(w.T.copy()), t(b), ln=(t(g), t(be)) if ln else None,
        residual=t(res).to(tdt) if residual else None)
    assert got.dtype == tdt and tuple(got.shape) == (B, T, N)
    if dtype == "f32":
        np.testing.assert_allclose(_np(got), _np(want), atol=1e-4, rtol=0)
    else:
        assert _cos(_np(got), _np(want)) > 0.9999
    xf = np.array(jnp.asarray(jnp.asarray(x, jdt), jnp.float32)).reshape(B * T, C)
    jx = jax_ffn._layernorm(jnp.asarray(xf), g, be) if ln else jnp.asarray(xf)
    tx = layer_norm_f32(t(xf), (t(g), t(be))) if ln else t(xf)
    codes_jax = np.asarray(jax_quant_rows(jx)[0])
    codes_port = quantize_rows(tx)[0].numpy()
    assert (codes_jax != codes_port).mean() <= 1e-3


@pytest.mark.parametrize("ln,residual", [(True, False), (False, True)], ids=["ln", "res"])
def test_k12_plain_matches_interpreted_pallas_at_the_panel_edges(ln, residual):
    """HuBERT-Base's width C = 768, B * T = 202 rows (not a multiple of the
    card kernel's 128-row panel) and N = 264 (not a multiple of its
    128-column tiles), bf16: the card kernel's edges, held here through the
    plain version that it is checked against on the card."""
    rng = np.random.RandomState(5)
    B, T, C, N = 2, 101, 768, 264
    x = rng.randn(B, T, C).astype(np.float32) * 0.5
    w = (rng.randn(C, N) / np.sqrt(C)).astype(np.float32)  # JAX layout [C, N]
    b = (rng.randn(N) * 0.02).astype(np.float32)
    g, be = (1 + 0.1 * rng.randn(C)).astype(np.float32), (0.1 * rng.randn(C)).astype(np.float32)
    res = rng.randn(B, T, N).astype(np.float32) * 0.5
    t = torch.from_numpy
    want = jax_ffn.fused_int8_linear(
        jnp.asarray(x, jnp.bfloat16), jnp.asarray(w), jnp.asarray(b),
        ln=(jnp.asarray(g), jnp.asarray(be)) if ln else None,
        residual=jnp.asarray(res, jnp.bfloat16) if residual else None, interpret=True)
    got = port_ffn.fused_int8_linear(
        t(x).bfloat16(), t(w.T.copy()), t(b), ln=(t(g), t(be)) if ln else None,
        residual=t(res).bfloat16() if residual else None)
    assert got.dtype == torch.bfloat16 and tuple(got.shape) == (B, T, N)
    assert _cos(_np(got), _np(want)) > 0.9999
    np.testing.assert_allclose(_np(got), _np(want), atol=6.25e-2, rtol=0)


# -- K11 ------------------------------------------------------------------------

@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("route,T,max_kernel_t", [("k11", 200, 2048), ("k10", 300, 128)])
def test_k11_plain_matches_interpreted_pallas(monkeypatch, route, T, max_kernel_t, dtype):
    """K11 at T = 200; beyond a patched MAX_KERNEL_T = 128 (T = 300) both
    hand over to K9 -> K10 and residual + int8_matmul. A pos_bias from a
    bucket table, gates in (1, 3), kv_lens [T, 5T/8, 1], a raw f32 out-proj
    weight quantized inside both."""
    for fa in (jax_fa, port_fa):
        monkeypatch.setattr(fa, "MAX_KERNEL_T", max_kernel_t)
    jdt, tdt = DTYPES[dtype]
    rng = np.random.RandomState(1)
    B, H, Dh = 3, 2, 64
    C = H * Dh
    qkv = rng.randn(B, T, 3 * C).astype(np.float32)
    x = rng.randn(B, T, C).astype(np.float32) * 0.5
    table = rng.randn(64, H).astype(np.float32)
    pos_bias = np.ascontiguousarray(table[jax_buckets(T, 64, 160)].transpose(2, 0, 1))
    gate = (1 + 2 * rng.rand(B, H, T)).astype(np.float32)
    wo = (rng.randn(C, C) / np.sqrt(C)).astype(np.float32)
    bo = (rng.randn(C) * 0.02).astype(np.float32)
    kv = np.array([T, (T * 5) // 8, 1], np.int32)
    plain = {"k11": "gated_bias_attention_outproj_reference",
             "k10": "gated_online_flash_attention_reference"}[route]
    calls = _spy(monkeypatch, port_fa, plain)
    want = jax_fa.gated_bias_attention_outproj(
        jnp.asarray(qkv, jdt), jnp.asarray(x, jdt), jnp.asarray(pos_bias), jnp.asarray(gate),
        jnp.asarray(wo), jnp.asarray(bo), jnp.asarray(kv), H, interpret=True)
    t = torch.from_numpy
    got = port_fa.gated_bias_attention_outproj(
        t(qkv).to(tdt), t(x).to(tdt), t(pos_bias), t(gate), t(wo.T.copy()), t(bo), t(kv), H)
    assert len(calls) == 1 and got.dtype == tdt and tuple(got.shape) == (B, T, C)
    got, want = _np(got), _np(want)
    for i, n in enumerate(kv):  # valid rows
        if dtype == "f32":
            err = np.abs(got[i, :n] - want[i, :n]).max(-1)
            assert (err > 2e-5).mean() <= 0.01 and err.max() <= 5e-3, (i, err.max())
        else:
            assert _cos(got[i, :n], want[i, :n]) > 0.9999, i


# -- the options through the models ---------------------------------------------------

def _perturbed(params):
    rng = np.random.RandomState(0)
    return jax.tree_util.tree_map(
        lambda a: np.asarray(a, np.float32) + 0.05 * rng.randn(*np.shape(a)).astype(np.float32),
        params)


@pytest.fixture(scope="module")
def hubert_params():
    """test_torch_port_slice.py's tiny trunk params (the jitted init)."""
    init = jax.jit(lambda key, w, n: JaxTrunk(hubert_tests.JCFG).init(key, w, n,
                                                                      deterministic=True))
    return _perturbed(init(jax.random.key(0), jnp.zeros((1, 3200)), jnp.asarray([3200]))["params"])


@pytest.fixture(scope="module")
def wavlm_params():
    init = jax.jit(lambda key, w, n: JaxWavLM(wavlm_tests.JCFG).init(key, w, n,
                                                                     deterministic=True))
    return _perturbed(init(jax.random.key(0), jnp.zeros((1, 3200)), jnp.asarray([3200]))["params"])


def _run_jax(model_cls, cfg, params, wavs, lens):
    """The int8 serving model (bf16, flash, quantize), jitted afresh: the
    S3PRL_* switches are read while it traces."""
    model = model_cls(cfg, dtype=jnp.bfloat16, use_flash=True, quantize=True)
    apply = jax.jit(lambda v, w, n: model.apply(v, w, n, deterministic=True))
    up = JaxUpstream(name="tiny", params={"params": params},
                     apply_fn=lambda v, w, n, train, rngs: apply(v, w, n),
                     num_layers=cfg.encoder_layers + 1, hidden_size=cfg.encoder_embed_dim,
                     downsample_rate=hubert_tests.STRIDE)
    hs, h_lens = up.apply_standardized(up.params, jnp.asarray(wavs), jnp.asarray(lens))
    return np.asarray(jnp.asarray(hs, jnp.float32)), np.asarray(h_lens)


def _port(model_cls, cfg, state_dict, **fuse):
    model = model_cls(cfg, dtype=torch.bfloat16, use_flash=True, quantize=True, device="meta",
                      **fuse)
    model.to_empty(device="cpu")
    model.load_state_dict(state_dict)  # builds the int8 cache
    return Upstream(name="tiny", model=model.eval(), num_layers=cfg.encoder_layers + 1,
                    hidden_size=cfg.encoder_embed_dim, downsample_rate=hubert_tests.STRIDE)


def _compare(want, up, wavs, lens):
    hs, h_lens = up.apply_standardized(torch.from_numpy(wavs), torch.from_numpy(lens))
    got_hs, got_lens = hs.float().numpy(), h_lens.numpy()
    np.testing.assert_array_equal(got_lens, want[1])
    assert got_hs.shape == want[0].shape
    coss = _layer_cosines(got_hs, want[0], got_lens)
    assert min(coss) > 0.999, coss


def _kernel_routes(monkeypatch, switch, **thresholds):
    monkeypatch.setenv(switch, "1")
    monkeypatch.setattr(jax_transformer, "_fused_block_available", lambda: True)
    monkeypatch.setattr(port_transformer, "_fused_block_available", lambda x: True)
    for name, value in thresholds.items():
        for fa in (jax_fa, port_fa):
            monkeypatch.setattr(fa, name, value)


def _refuse(*args, **kwargs):
    raise AssertionError("a kernel the option replaces")


@pytest.mark.parametrize("max_kernel_t", [2048, 128], ids=["k7", "k8"])
def test_hubert_full_fuse_matches_jax(hubert_params, monkeypatch, max_kernel_t):
    """``full_fuse`` / S3PRL_FULL_FUSE=1 at T' = 320 frames (no K1 even
    though T <= MAX_BLOCK_T): per layer K12(LN, QKV), K7 (K8 beyond a
    patched MAX_KERNEL_T = 128), K12(out-proj, residual), K2."""
    _kernel_routes(monkeypatch, "S3PRL_FULL_FUSE", MAX_KERNEL_T=max_kernel_t)
    monkeypatch.setattr(port_transformer, "fused_attention_block", _refuse)
    jax_calls = _spy(monkeypatch, jax_ffn, "fused_int8_linear")
    port_calls = _spy(monkeypatch, port_ffn, "fused_int8_linear_reference")
    attn = _spy(monkeypatch, port_fa, "fused_qkv_attention_reference" if max_kernel_t == 2048
                else "online_flash_attention_reference")
    wavs, lens = _batch(21, [6400, 3001, 1])
    want = _run_jax(JaxTrunk, hubert_tests.JCFG, hubert_params, wavs, lens)
    up = _port(Wav2Vec2Trunk, hubert_tests.PCFG,
               trunk_state_dict_from_jax(hubert_params, hubert_tests.PCFG), full_fuse=True)
    _compare(want, up, wavs, lens)
    assert len(jax_calls) == 4 and len(port_calls) == 4 and len(attn) == 2  # 2 layers
    # (x, w, b, ln, residual): the QKV with the LN, then the out-proj with x
    assert [(a[3] is not None, a[4] is not None) for a, _ in port_calls] == [
        (True, False), (False, True)] * 2


def test_hubert_qkv_fuse_matches_jax(hubert_params, monkeypatch):
    """``qkv_fuse`` / S3PRL_QKV_FUSE=1 at T' = 320 frames beyond a patched
    MAX_BLOCK_T = 64: K12(LN, QKV) in place of the LN + int8_matmul pair,
    then K6."""
    _kernel_routes(monkeypatch, "S3PRL_QKV_FUSE", MAX_BLOCK_T=64)
    monkeypatch.setattr(port_transformer, "int8_matmul", _refuse)
    jax_calls = _spy(monkeypatch, jax_ffn, "fused_int8_linear")
    port_calls = _spy(monkeypatch, port_ffn, "fused_int8_linear_reference")
    k6 = _spy(monkeypatch, port_fa, "fused_qkv_attention_outproj_reference")
    wavs, lens = _batch(22, [6400, 3001, 1])
    want = _run_jax(JaxTrunk, hubert_tests.JCFG, hubert_params, wavs, lens)
    up = _port(Wav2Vec2Trunk, hubert_tests.PCFG,
               trunk_state_dict_from_jax(hubert_params, hubert_tests.PCFG), qkv_fuse=True)
    _compare(want, up, wavs, lens)
    assert len(jax_calls) == len(port_calls) == len(k6) == 2
    assert all(a[3] is not None and a[4] is None for a, _ in port_calls)  # LN, no residual


def test_hubert_qkv_fuse_is_inert_within_max_block_t(hubert_params, monkeypatch):
    """At T <= MAX_BLOCK_T the option leaves K1 in place, as the JAX
    package's switch does (transformer.py:447-471)."""
    _kernel_routes(monkeypatch, "S3PRL_QKV_FUSE")
    monkeypatch.setattr(port_ffn, "fused_int8_linear_reference", _refuse)
    k1 = _spy(monkeypatch, port_fa, "fused_attention_block_reference")
    sd = trunk_state_dict_from_jax(hubert_params, hubert_tests.PCFG)
    wavs, lens = _batch(23, [3200, 1600])
    got = _port(Wav2Vec2Trunk, hubert_tests.PCFG, sd, qkv_fuse=True).apply_standardized(
        torch.from_numpy(wavs), torch.from_numpy(lens))[0]
    want = _port(Wav2Vec2Trunk, hubert_tests.PCFG, sd).apply_standardized(
        torch.from_numpy(wavs), torch.from_numpy(lens))[0]
    assert len(k1) == 4 and torch.equal(got, want)


@pytest.mark.parametrize("max_kernel_t", [2048, 128], ids=["k11", "k10"])
def test_wavlm_fuse_matches_jax(wavlm_params, monkeypatch, max_kernel_t):
    """``wavlm_fuse`` / S3PRL_WAVLM_FUSE=1 at T' = 160 frames: int8_matmul
    QKV, then K11 (beyond a patched MAX_KERNEL_T = 128 its hand-over to
    K9 -> K10 and residual + int8_matmul), then K2; K9's own route unused."""
    _kernel_routes(monkeypatch, "S3PRL_WAVLM_FUSE", MAX_KERNEL_T=max_kernel_t)
    jax_calls = _spy(monkeypatch, jax_fa, "gated_bias_attention_outproj")
    port_calls = _spy(monkeypatch, port_wavlm, "gated_bias_attention_outproj")
    plain = _spy(monkeypatch, port_fa, "gated_bias_attention_outproj_reference"
                 if max_kernel_t == 2048 else "gated_online_flash_attention_reference")
    monkeypatch.setattr(port_transformer, "gated_bias_attention", _refuse)  # SelfAttention's K9
    wavs, lens = _batch(24, wavlm_tests.LENS)
    want = _run_jax(JaxWavLM, wavlm_tests.JCFG, wavlm_params, wavs, lens)
    up = _port(WavLMModel, wavlm_tests.PCFG,
               wavlm_state_dict_from_jax(wavlm_params, wavlm_tests.PCFG), wavlm_fuse=True)
    _compare(want, up, wavs, lens)
    assert len(jax_calls) == len(port_calls) == len(plain) == 2
    pos_bias, gate = port_calls[0][0][2], port_calls[0][0][3]
    assert pos_bias.dtype == gate.dtype == torch.float32
    assert port_calls[0][0][2] is port_calls[1][0][2]  # one pos_bias for both layers


# -- the keywords ---------------------------------------------------------------------

@pytest.mark.parametrize("name,kwargs,match", [
    ("hubert_large_ll60k", dict(wavlm_fuse=True), "wavlm_fuse cannot take effect"),
    ("wavlm_large", dict(qkv_fuse=True), "qkv_fuse cannot take effect"),
    ("wavlm_large", dict(full_fuse=True), "full_fuse cannot take effect"),
    ("hubert_large_ll60k", dict(full_fuse=True, quantize=False), "quantize=True and flash"),
    ("hubert_large_ll60k", dict(qkv_fuse=True, flash=False), "quantize=True and flash"),
    ("wavlm_large", dict(wavlm_fuse=True, quantize=False), "quantize=True and flash"),
], ids=["wavlm_fuse-on-hubert", "qkv_fuse-on-wavlm", "full_fuse-on-wavlm", "full_fuse-bf16",
        "qkv_fuse-no-flash", "wavlm_fuse-bf16"])
def test_fuse_keywords_refuse_what_cannot_take_effect(name, kwargs, match):
    """At load, before any weight is built (the full-size configurations)."""
    kwargs = {"dtype": torch.bfloat16, "flash": True, "quantize": True, **kwargs}
    with pytest.raises(ValueError, match=match):
        hub.load(name, device="cpu", **kwargs)


def test_fuse_keywords_reach_the_layers_and_are_not_state(monkeypatch):
    """hub.load's keywords land on every layer as plain attributes; the
    state_dict keeps the fairseq / Microsoft keys, and default models have
    every option off."""
    monkeypatch.setattr(port_registry, "HUBERT_LARGE", hubert_tests.PCFG)
    monkeypatch.setattr(port_registry, "WAVLM_LARGE", wavlm_tests.PCFG)
    kw = dict(dtype=torch.bfloat16, flash=True, quantize=True, device="cpu")
    for name, option in (("hubert_large_ll60k", "full_fuse"), ("hubert_large_ll60k", "qkv_fuse"),
                         ("wavlm_large", "wavlm_fuse")):
        plain, fused = hub.load(name, **kw), hub.load(name, **kw, **{option: True})
        assert [getattr(layer, option) for layer in fused.model.encoder.layers] == [True] * 2
        assert [getattr(layer, option) for layer in plain.model.encoder.layers] == [False] * 2
        assert fused.model.state_dict().keys() == plain.model.state_dict().keys()


@pytest.mark.parametrize("option", ["full_fuse", "qkv_fuse", "wavlm_fuse"])
def test_train_mode_takes_the_module_path(hubert_params, wavlm_params, monkeypatch, option):
    """K11 and K12 are forward-only: a layer in train() mode takes the
    module path whatever its option (as the JAX package's `deterministic`
    gates them), and its values equal the eval-mode module path's."""
    monkeypatch.setattr(port_transformer, "_fused_block_available", lambda x: True)
    monkeypatch.setattr(port_transformer, "fused_int8_linear", _refuse)
    monkeypatch.setattr(port_wavlm, "gated_bias_attention_outproj", _refuse)
    monkeypatch.setattr(port_fa, "MAX_BLOCK_T", 64)
    x = torch.from_numpy(np.random.RandomState(25).randn(2, 100, 128).astype(np.float32))
    x = x.bfloat16()
    kv = torch.tensor([100, 40], dtype=torch.int32)
    pad = torch.arange(100)[None, :] >= kv[:, None]
    if option == "wavlm_fuse":
        up = _port(WavLMModel, wavlm_tests.PCFG,
                   wavlm_state_dict_from_jax(wavlm_params, wavlm_tests.PCFG), wavlm_fuse=True)
        args = up.model.encoder._layer_args(100, x.device)
    else:
        up = _port(Wav2Vec2Trunk, hubert_tests.PCFG,
                   trunk_state_dict_from_jax(hubert_params, hubert_tests.PCFG), **{option: True})
        args = ()
    layer = up.model.encoder.layers[0].train()
    with torch.no_grad():
        got = layer(x, kv, pad, *args)
    monkeypatch.setattr(port_transformer, "_fused_block_available", lambda x: False)
    with torch.no_grad():
        assert torch.equal(got, layer.eval()(x, kv, pad, *args))
