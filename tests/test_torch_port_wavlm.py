"""WavLM (gated relative-position bias) in s3prl_tpu_torch vs s3prl_tpu (CPU).

K9 `gated_bias_attention` and K10 `gated_online_flash_attention` (the port
of `_gated_online_flash_kernel`): the port's wrappers on CPU tensors (their
plain versions) against the JAX functions with their Pallas kernels in
interpret mode, on the same numpy inputs. Then a tiny WavLM-Large-style
model (layer-norm extractor, 2 pre-LN layers, C=128, H=4, FFN 256, 32
buckets up to distance 80, normalize=True), initialised in JAX with every
leaf perturbed, carried to the port with `wavlm_state_dict_from_jax`, and
both packages' `apply_standardized` on the same numpy batch. Tolerances:
- K9/K10 with f32 inputs: atol 2e-5 over valid rows (the bar of
  tests/test_kernels.py:15-33, the Pallas kernel against XLA math); bf16
  inputs: cosine > 0.9999 (only the order of f32 sums differs, then one
  bf16 rounding);
- the model in f32 without flash: per-layer hidden states at atol 5e-4 over
  valid frames (the ROADMAP bar); bf16 and int8: per-layer cosine > 0.999
  over valid frames (the JAX package's gate for its reduced-precision
  paths); lengths exactly equal;
- the bucket table, the weight round trip and the rounding points: exact
  (the pos-conv kernel, which the JAX converter folds from weight_g and
  weight_v, at rtol 1e-6).
Every test runs with the JAX package's default knobs.
"""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

import s3prl_tpu.kernels.flash_attention as jax_fa
import s3prl_tpu.models.transformer as jax_transformer
import s3prl_tpu_torch.kernels.flash_attention as port_fa
import s3prl_tpu_torch.models.convfe as port_convfe
import s3prl_tpu_torch.models.transformer as port_transformer
import s3prl_tpu_torch.models.wavlm as port_wavlm
import s3prl_tpu_torch.upstream.registry as port_registry
from s3prl_tpu.models.wavlm import WavLMConfig as JaxConfig
from s3prl_tpu.models.wavlm import WavLMModel as JaxWavLM
from s3prl_tpu.models.wavlm import relative_position_buckets as jax_buckets
from s3prl_tpu.upstream.base import Upstream as JaxUpstream
from s3prl_tpu.upstream.convert import wavlm_params_from_torch
from s3prl_tpu_torch import hub
from s3prl_tpu_torch.models.wavlm import WavLMConfig, WavLMModel
from s3prl_tpu_torch.upstream.base import Upstream
from s3prl_tpu_torch.upstream.convert import wavlm_state_dict_from_jax
from test_torch_port_slice import (  # noqa: F401 (fixtures)
    _batch, _cos, _jax_defaults, _layer_cosines, _valid_frames)

TINY = dict(
    extractor_mode="layer_norm",
    conv_feature_layers=((64, 10, 5), (64, 3, 2), (64, 2, 2)),
    encoder_layers=2, encoder_embed_dim=128, encoder_ffn_embed_dim=256,
    encoder_attention_heads=4, conv_pos=16, conv_pos_groups=4,
    layer_norm_first=True, dropout=0.0, attention_dropout=0.0,
    dropout_input=0.0, normalize=True, num_buckets=32, max_distance=80,
)
JCFG, PCFG = JaxConfig(**TINY), WavLMConfig(**TINY)
STRIDE = 20
LENS = [3200, 1501, 1]  # T' = 160 frames; one utterance of a single frame
PRECISION = {"f32": (jnp.float32, torch.float32, False, False),
             "bf16": (jnp.bfloat16, torch.bfloat16, True, False),
             "int8": (jnp.bfloat16, torch.bfloat16, True, True)}


@pytest.fixture(scope="module")
def jax_params():
    """Random JAX WavLM params, every leaf perturbed by numpy noise."""
    wavs = jnp.zeros((1, 3200), jnp.float32)
    init = jax.jit(lambda key, w, n: JaxWavLM(JCFG).init(key, w, n, deterministic=True))
    params = init(jax.random.key(0), wavs, jnp.asarray([3200]))["params"]  # jit: ~6x faster
    rng = np.random.RandomState(0)
    return jax.tree_util.tree_map(
        lambda a: np.asarray(a, np.float32)
        + 0.05 * rng.randn(*np.shape(a)).astype(np.float32), params)


def _run_jax(params, wavs, lens, precision="f32"):
    dtype, _, flash, quantize = PRECISION[precision]
    model = JaxWavLM(JCFG, dtype=dtype, use_flash=flash, quantize=quantize)
    apply = jax.jit(lambda v, w, l: model.apply(v, w, l, deterministic=True))
    up = JaxUpstream(
        name="tiny", params={"params": params},
        apply_fn=lambda v, w, l, train, rngs: apply(v, w, l),
        num_layers=JCFG.encoder_layers + 1, hidden_size=JCFG.encoder_embed_dim,
        downsample_rate=STRIDE)
    hs, h_lens = up.apply_standardized(up.params, jnp.asarray(wavs), jnp.asarray(lens))
    return np.asarray(jnp.asarray(hs, jnp.float32)), np.asarray(h_lens)


def _port(params, precision="f32", flash=None):
    _, dtype, default_flash, quantize = PRECISION[precision]
    flash = default_flash if flash is None else flash
    model = WavLMModel(PCFG, dtype=dtype, use_flash=flash, quantize=quantize, device="meta")
    model.to_empty(device="cpu")
    model.load_state_dict(wavlm_state_dict_from_jax(params, PCFG))  # builds the int8 cache
    return Upstream(name="tiny", model=model.eval(), num_layers=PCFG.encoder_layers + 1,
                    hidden_size=PCFG.encoder_embed_dim, downsample_rate=STRIDE)


def _run_port(up, wavs, lens):
    hs, h_lens = up.apply_standardized(torch.from_numpy(wavs), torch.from_numpy(lens))
    return hs.float().numpy(), h_lens.numpy()


def _kernels_on(monkeypatch):
    """Both packages take their kernel routes on the CPU (JAX: Pallas in
    interpret mode; the port: its wrappers, whose plain versions run)."""
    monkeypatch.setattr(jax_transformer, "_fused_block_available", lambda: True)
    monkeypatch.setattr(port_transformer, "_fused_block_available", lambda x: True)


def _max_kernel_t(monkeypatch, value):
    for fa in (jax_fa, port_fa):
        monkeypatch.setattr(fa, "MAX_KERNEL_T", value)


def _spy(monkeypatch, module, name):
    """Replaces module.name by a wrapper that records its arguments."""
    calls, fn = [], getattr(module, name)
    monkeypatch.setattr(module, name, lambda *a, **k: calls.append((a, k)) or fn(*a, **k))
    return calls


# -- the bucket table ---------------------------------------------------------

@pytest.mark.parametrize("nb,md", [(320, 800), (32, 80)])
@pytest.mark.parametrize("T", [1, 7, 499, 1500, 2999])
def test_bucket_table_equals_jax(T, nb, md):
    want = jax_buckets(T, nb, md)
    got = port_wavlm.relative_position_buckets(T, nb, md)
    assert got.dtype == want.dtype == np.int64
    np.testing.assert_array_equal(got, want)
    table = port_wavlm.bucket_table(T, nb, md, torch.device("cpu"))
    assert table.dtype == torch.int64 and np.array_equal(table.numpy(), want)


# -- K9 and K10 ---------------------------------------------------------------

def _gated_inputs(seed, B, H, T, Dh=64):
    rng = np.random.RandomState(seed)
    q, k, v = (rng.randn(B, H, T, Dh).astype(np.float32) * s for s in (Dh ** -0.5, 1, 1))
    table = rng.randn(64, H).astype(np.float32)
    pos_bias = np.ascontiguousarray(table[jax_buckets(T, 64, 160)].transpose(2, 0, 1))
    gate = 1.0 + 2.0 * rng.rand(B, H, T).astype(np.float32)  # in (1, 3)
    kv = np.array([T, (T * 5) // 8, 1][:B], np.int32)
    return q, k, v, pos_bias, gate, kv


@pytest.mark.parametrize("dtype", ["f32", "bf16"])
@pytest.mark.parametrize("kernel,max_kernel_t", [("k9", 2048), ("k10", 128)])
def test_gated_kernels_plain_match_interpreted_pallas(monkeypatch, kernel, max_kernel_t, dtype):
    """K9 at T = 200; K10 through K9's hand-over at T = 300 > MAX_KERNEL_T =
    128 (patched in both packages); kv_lens include 1."""
    _max_kernel_t(monkeypatch, max_kernel_t)
    jdt, tdt = {"f32": (jnp.float32, torch.float32), "bf16": (jnp.bfloat16, torch.bfloat16)}[dtype]
    T = 200 if kernel == "k9" else 300
    q, k, v, pos_bias, gate, kv = _gated_inputs(1, 3, 2, T)
    plain = {"k9": "gated_bias_attention_reference",
             "k10": "gated_online_flash_attention_reference"}[kernel]
    calls = _spy(monkeypatch, port_fa, plain)
    want = jax_fa.gated_bias_attention(*(jnp.asarray(a, jdt) for a in (q, k, v)),
                                       jnp.asarray(pos_bias), jnp.asarray(gate),
                                       jnp.asarray(kv), interpret=True)
    got = port_fa.gated_bias_attention(*(torch.from_numpy(a).to(tdt) for a in (q, k, v)),
                                       torch.from_numpy(pos_bias), torch.from_numpy(gate),
                                       torch.from_numpy(kv))
    assert len(calls) == 1 and got.dtype == tdt
    got = got.float().numpy()
    want = np.asarray(jnp.asarray(want, jnp.float32))
    for b, n in enumerate(kv):  # valid query rows
        if dtype == "f32":
            np.testing.assert_allclose(got[b, :, :n], want[b, :, :n], atol=2e-5, rtol=0)
        else:
            assert _cos(got[b, :, :n], want[b, :, :n]) > 0.9999, b


@pytest.mark.parametrize("kernel,max_kernel_t", [("k9", 2048), ("k10", 64)])
def test_gated_kernels_keep_their_mask_constants(monkeypatch, kernel, max_kernel_t):
    """Valid scores near -2e9 tell the two masks apart: with K9's -1e9 the
    masked keys win the softmax, with K10's -1e30 the valid ones do. The
    plain versions follow their Pallas cells in both."""
    _max_kernel_t(monkeypatch, max_kernel_t)
    B, H, T = 1, 1, 100
    q, k, v, _, gate, _ = _gated_inputs(2, B, H, T)
    gate = np.ones_like(gate)
    pos_bias = np.full((H, T, T), -2e9, np.float32)
    kv = np.array([60], np.int32)
    want = jax_fa.gated_bias_attention(*(jnp.asarray(a) for a in (q, k, v, pos_bias, gate, kv)),
                                       interpret=True)
    got = port_fa.gated_bias_attention(*(torch.from_numpy(a) for a in (q, k, v, pos_bias, gate,
                                                                       kv)))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=2e-5, rtol=0)
    masked_mean = v[0, 0, 60:].mean(0)
    assert np.allclose(got.numpy()[0, 0, 0], masked_mean, atol=1e-5) == (kernel == "k9")


# -- the model ----------------------------------------------------------------

def test_wavlm_f32_matches_jax(jax_params):
    wavs, lens = _batch(1, LENS)
    want, want_lens = _run_jax(jax_params, wavs, lens)
    got, got_lens = _run_port(_port(jax_params), wavs, lens)
    np.testing.assert_array_equal(got_lens, want_lens)
    assert got.shape == want.shape == (3, 3, 160, 128)
    for layer in range(got.shape[0]):
        for b, n in enumerate(_valid_frames(got_lens, got.shape[2])):
            np.testing.assert_allclose(got[layer, b, :n], want[layer, b, :n], atol=5e-4,
                                       err_msg=f"layer {layer} utterance {b}")


ROUTES = {  # precision-route -> (MAX_KERNEL_T, the port's plain attention that must run)
    "bf16-k9": ("bf16", 2048, "gated_bias_attention_reference"),
    "int8-k9": ("int8", 2048, "gated_bias_attention_reference"),
    "bf16-k10": ("bf16", 128, "gated_online_flash_attention_reference"),
    "int8-k10": ("int8", 128, "gated_online_flash_attention_reference"),
}


@pytest.mark.parametrize("route", ROUTES)
def test_wavlm_kernel_routes_match_jax(jax_params, monkeypatch, route):
    """bf16 (K9, or K10 with MAX_KERNEL_T = 128) and int8 (the same plus K2)
    through both packages' kernel routes: JAX's Pallas kernels in interpret
    mode, the port's wrappers on CPU tensors. Neither precision runs K1,
    K4, K5, K6 or K7."""
    precision, max_kernel_t, plain = ROUTES[route]
    _kernels_on(monkeypatch)
    _max_kernel_t(monkeypatch, max_kernel_t)

    def refuse(*args, **kwargs):
        raise AssertionError("a HuBERT block kernel in WavLM")

    for name in ("fused_attention_block", "fused_attention_block_bf16", "fused_bf16_ffn",
                 "fused_qkv_attention", "fused_qkv_attention_outproj"):
        monkeypatch.setattr(port_transformer, name, refuse)
    attn_calls = _spy(monkeypatch, port_fa, plain)
    ffn_calls = _spy(monkeypatch, port_wavlm, "fused_int8_ffn")
    wavs, lens = _batch(2, LENS)
    want, want_lens = _run_jax(jax_params, wavs, lens, precision)
    got, got_lens = _run_port(_port(jax_params, precision), wavs, lens)
    assert len(attn_calls) == 2  # one per layer
    assert len(ffn_calls) == (2 if precision == "int8" else 0)
    np.testing.assert_array_equal(got_lens, want_lens)
    assert got.shape == want.shape == (3, 3, 160, 128)
    coss = _layer_cosines(got, want, got_lens)
    assert min(coss) > 0.999, coss


def test_wavlm_int8_module_path_matches_jax(jax_params):
    """int8 without the kernel routes (no CUDA): int8_matmul projections
    around K9's plain version and the erf FFN, in both packages."""
    wavs, lens = _batch(3, LENS)
    want, want_lens = _run_jax(jax_params, wavs, lens, "int8")
    got, got_lens = _run_port(_port(jax_params, "int8"), wavs, lens)
    np.testing.assert_array_equal(got_lens, want_lens)
    coss = _layer_cosines(got, want, got_lens)
    assert min(coss) > 0.999, coss


def test_wavlm_int8_quality_against_f32(jax_params, monkeypatch):
    """The port's int8 serving route against its own f32 model on the same
    weights: per-layer cosine > 0.999 (tests/test_quant.py:306-333)."""
    _kernels_on(monkeypatch)
    wavs, lens = _batch(4, [6400, 4800])
    want, want_lens = _run_port(_port(jax_params), wavs, lens)
    got, got_lens = _run_port(_port(jax_params, "int8"), wavs, lens)
    np.testing.assert_array_equal(got_lens, want_lens)
    coss = _layer_cosines(got, want, got_lens)
    assert min(coss) > 0.999, coss


# -- the places where the port can drift ----------------------------------------

@pytest.mark.parametrize("precision", ["f32", "bf16"])
def test_pos_bias_is_built_once_and_rounded_to_the_model_dtype(jax_params, monkeypatch,
                                                              precision):
    """One pos_bias per forward, the same tensor in every layer: the bias
    table gathered by the bucket table and rounded to the model dtype
    (wavlm.py:304-308), handed to K9 in f32 by the f32 model and as the
    bf16 model's padded bf16 buffer (rows a multiple of 8 elements apart)
    by the bf16 one; the gate K9 gets is a value of the model dtype
    (wavlm.py:122-128), in f32."""
    calls = _spy(monkeypatch, port_fa, "gated_bias_attention_reference")
    up = _port(jax_params, precision, flash=True)
    wavs, lens = _batch(5, [3200, 1600])
    _run_port(up, wavs, lens)
    (a0, _), (a1, _) = calls
    assert a0[3] is a1[3]  # pos_bias: one tensor for both layers
    pos_bias, gate = a0[3], a0[4]
    dtype = PRECISION[precision][1]
    table = up.model.encoder.layers[0].self_attn.relative_attention_bias.weight
    T = pos_bias.shape[-1]
    want = table.detach()[torch.from_numpy(jax_buckets(T, 32, 80))].permute(2, 0, 1)
    assert pos_bias.dtype == dtype and gate.dtype == torch.float32
    if precision == "bf16":
        assert pos_bias.stride() == (T * pos_bias.stride(1), pos_bias.stride(1), 1)
        assert pos_bias.stride(1) % 8 == 0 and pos_bias.stride(1) >= T
    assert torch.equal(pos_bias.float(), want.to(dtype).float())
    assert torch.equal(gate, gate.to(dtype).float())


def test_gate_matches_jax_layer(jax_params, monkeypatch):
    """The bf16 gate of one layer against the JAX layer's on the same bf16
    input (K9's `gate` argument of both packages): every value within one
    bf16 step (the Dense dot sums in another order), most equal."""
    from s3prl_tpu.models.wavlm import GatedRelPosLayer as JaxLayer

    rng = np.random.RandomState(6)
    B, T, C, H = 2, 40, 128, 4
    x = rng.randn(B, T, C).astype(np.float32)
    seen = {}
    real = jax_fa.gated_bias_attention
    monkeypatch.setattr(jax_fa, "gated_bias_attention",
                        lambda *a, **k: seen.setdefault("jax", np.asarray(a[4])) is None
                        or real(*a, **k))
    pos_bias = np.zeros((H, T, T), np.float32)
    layer_params = jax.tree_util.tree_map(lambda a: a[0], jax_params["layers"])
    JaxLayer(C, 256, H, layer_norm_first=True, use_flash=True, dtype=jnp.bfloat16).apply(
        {"params": layer_params}, jnp.asarray(x, jnp.bfloat16), None,
        jnp.asarray(pos_bias, jnp.bfloat16))
    layer = _port(jax_params, "bf16").model.encoder.layers[0]
    h = port_transformer._layer_norm(torch.from_numpy(x).bfloat16(), layer.self_attn_layer_norm)
    with torch.no_grad():
        got = layer.self_attn.gate(h)
    assert got.dtype == torch.bfloat16
    got, want = got.float().numpy(), seen["jax"]
    step = np.exp2(np.floor(np.log2(np.maximum(np.abs(want), 2.0 ** -126))) - 7)
    assert (np.abs(got - want) <= step).all()
    assert (got == want).mean() > 0.9


def test_int8_wavlm_extractor_runs_erf(monkeypatch):
    """The JAX WavLM passes no `quantize` to its extractor, so its int8
    path runs K3 in erf mode (convfe.py:275), unlike HuBERT's tanh."""
    modes = []
    real = port_convfe.conv0_ln_gelu
    monkeypatch.setattr(port_convfe, "conv0_ln_gelu",
                        lambda *a, **k: modes.append(k["gelu_mode"]) or real(*a, **k))
    model = WavLMModel(PCFG, torch.bfloat16, use_flash=True, quantize=True)
    assert not model.feature_extractor.quantize
    model.eval().feature_extractor(torch.zeros(1, 1600))
    assert modes == ["erf"]


def test_wavlm_state_dict_round_trip_is_exact(jax_params):
    """The port's state_dict (Microsoft's keys, the bias table in layer 0)
    -> the JAX `wavlm_params_from_torch`, with the pos-conv split into
    weight_g / weight_v as Microsoft's checkpoints hold it: the JAX tree
    comes back bit for bit; the pos-conv kernel, which the JAX converter
    folds again, at rtol 1e-6. The int8 model keeps the same keys."""
    sd = _port(jax_params).model.state_dict()
    assert sd.keys() == _port(jax_params, "int8").model.state_dict().keys()
    assert "encoder.layers.0.self_attn.relative_attention_bias.weight" in sd
    assert "encoder.layers.1.self_attn.relative_attention_bias.weight" not in sd
    w = sd.pop("encoder.pos_conv.0.weight")
    sd["encoder.pos_conv.0.weight_g"] = w.norm(dim=(0, 1), keepdim=True)
    sd["encoder.pos_conv.0.weight_v"] = w
    tree = wavlm_params_from_torch(sd, JCFG)
    flat_b = dict(jax.tree_util.tree_leaves_with_path(jax_params))
    flat_a = jax.tree_util.tree_leaves_with_path(tree)
    assert len(flat_a) == len(flat_b)
    for path, leaf in flat_a:
        if "pos_conv" in jax.tree_util.keystr(path) and "kernel" in jax.tree_util.keystr(path):
            np.testing.assert_allclose(leaf, flat_b[path], rtol=1e-6, atol=0)
        else:
            np.testing.assert_array_equal(leaf, flat_b[path], err_msg=str(path))


def test_wavlm_large_entry_loads_at_tiny_width(monkeypatch, tmp_path):
    """hub.load("wavlm_large", device="cpu") at the tiny width (the same
    code path): int8 cache built from f32 weights, the table on layer 0,
    grep_a ones; a conformer WavLM and a native msgpack checkpoint are not
    ported."""
    monkeypatch.setattr(port_registry, "WAVLM_LARGE", PCFG)
    up = hub.load("wavlm_large", dtype=torch.bfloat16, flash=True, quantize=True,
                  device="cpu", seed=1)
    assert isinstance(up.model, WavLMModel) and up.num_layers == 3
    layer = up.model.encoder.layers[0]
    assert layer.fc1.weight.dtype == torch.float32 and layer.qpair("fc1")[0].dtype == torch.int8
    assert torch.equal(layer.self_attn.grep_a, torch.ones(1, 4, 1, 1))
    assert float(layer.self_attn.relative_attention_bias.weight.detach().std()) < 0.05
    wavs, lens = _batch(7, [3200, 20])
    hs, h_lens = up.apply_standardized(torch.from_numpy(wavs), torch.from_numpy(lens))
    assert hs.shape == (3, 2, 160, 128) and h_lens.tolist() == [160, 1]
    assert bool(torch.isfinite(hs).all())
    with pytest.raises(NotImplementedError, match="layer_type 'conformer'"):
        WavLMModel(WavLMConfig(**{**TINY, "layer_type": "conformer"}), device="meta")
    # a native msgpack checkpoint: the JAX package's WavLM loader reads
    # torch checkpoints only (its torch.load fails), and the port's refuses
    from flax import serialization

    from s3prl_tpu import hub as jax_hub

    native = tmp_path / "model.msgpack"
    native.write_bytes(serialization.to_bytes({"feature_extractor": {"w": np.ones(2)}}))
    with pytest.raises(Exception, match="unpickling"):
        jax_hub.load("wavlm_large", ckpt=str(native))
    with pytest.raises(NotImplementedError, match="msgpack.*only the trunk entries"):
        hub.load("wavlm_large", ckpt=str(native), device="cpu")
