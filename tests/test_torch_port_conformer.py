"""wav2vec2-Conformer of s3prl_tpu_torch vs s3prl_tpu (CPU).

A tiny Conformer trunk (the real seven-layer conv stack at 64 channels,
the layer-norm extractor, two layers at C 128, H 2, FFN 256, depthwise k
7; the conv length rule and wave normalisation of the entries) is
initialised in JAX, every parameter perturbed and the BatchNorm statistics
drawn away from 0 / 1 (means N(0, 0.05), variances in [0.5, 0.7]), and
carried to the port with `trunk_state_dict_from_jax`, which reads the
``batch_stats`` collection. The same numpy batch, with utterances of 399
and 1 samples (no frame under the conv rule) beside longer ones, goes
through `Upstream.apply_standardized` of both packages. Tolerances: f32
per-layer hidden states at atol 5e-4 over the valid frames (the bar of
tests/test_torch_parity.py:142), bf16 per-layer cosine > 0.999 there,
lengths equal; the relative-position table and `_rel_shift` exactly.
"""

import dataclasses

import numpy as np
import pytest
import torch

import flax
import jax
import jax.numpy as jnp

import s3prl_tpu.upstream.registry as jax_registry
import s3prl_tpu_torch.upstream.registry as port_registry
from s3prl_tpu import hub as jax_hub
from s3prl_tpu.models import transformer as jax_transformer
from s3prl_tpu.models.wav2vec2 import Wav2Vec2Config as JaxConfig
from s3prl_tpu.models.wav2vec2 import Wav2Vec2Trunk as JaxTrunk
from s3prl_tpu.upstream.base import Upstream as JaxUpstream
from s3prl_tpu_torch import hub
from s3prl_tpu_torch.models import transformer as port_transformer
from s3prl_tpu_torch.models.wav2vec2 import Wav2Vec2Config, Wav2Vec2Trunk
from s3prl_tpu_torch.upstream.base import TrunkUpstream
from s3prl_tpu_torch.upstream.convert import trunk_state_dict_from_jax
from test_torch_port_slice import _batch, _jax_defaults, _layer_cosines  # noqa: F401 (fixture)
from test_torch_port_w2v2 import CONV, LENS, assert_f32_close, run_port

STRIDE = 320
TINY = dict(conv_feature_layers=CONV, encoder_layers=2, encoder_embed_dim=128,
            encoder_ffn_embed_dim=256, encoder_attention_heads=2, dropout=0.0,
            attention_dropout=0.0, dropout_input=0.0, layer_type="conformer",
            extractor_mode="layer_norm", normalize=True, feat_pad_rule="conv",
            depthwise_conv_kernel_size=7)
POS = ("rel_pos", "rope", "abs")
DTYPES = {"f32": (jnp.float32, torch.float32), "bf16": (jnp.bfloat16, torch.bfloat16)}
_APPLY = {}  # (pos, precision, quantize) -> the jitted JAX apply


def configs(pos):
    kw = {**TINY, "pos_enc_type": pos}
    return JaxConfig(**kw), Wav2Vec2Config(**kw)


@pytest.fixture(scope="module")
def variables():
    """Per position type: JAX variables, every parameter + 0.05 N(0, 1),
    the BatchNorm means N(0, 0.05) and variances 0.5 + |0.05 N(0, 1)|."""
    out = {}
    for pos in POS:
        model = JaxTrunk(configs(pos)[0])
        v = jax.jit(lambda k: model.init(k, jnp.zeros((1, 3200)), jnp.asarray([3200]),
                                         deterministic=True))(jax.random.key(0))
        rng = np.random.RandomState(POS.index(pos))
        noise = lambda a: 0.05 * rng.randn(*np.shape(a)).astype(np.float32)  # noqa: E731
        stats = v["batch_stats"]["encoder"]["layers"]["conv_bn"]
        out[pos] = {
            "params": jax.tree_util.tree_map(lambda a: np.asarray(a) + noise(a), v["params"]),
            "batch_stats": {"encoder": {"layers": {"conv_bn": {
                "mean": noise(stats["mean"]), "var": 0.5 + np.abs(noise(stats["var"]))}}}}}
    return out


def jax_apply(pos, precision="f32", quantize=False):
    key = (pos, precision, quantize)
    if key not in _APPLY:
        model = JaxTrunk(configs(pos)[0], dtype=DTYPES[precision][0], quantize=quantize)
        _APPLY[key] = jax.jit(lambda v, w, n, lw=None: model.apply(
            v, w, n, deterministic=True, layer_weights=lw))
    return _APPLY[key]


def run_jax(pos, v, wavs, lens, precision="f32", quantize=False):
    apply = jax_apply(pos, precision, quantize)
    up = JaxUpstream(name="tiny", params=v, apply_fn=lambda v, w, n, train, rngs: apply(v, w, n),
                     num_layers=3, hidden_size=128, downsample_rate=STRIDE)
    hs, h_lens = up.apply_standardized(v, jnp.asarray(wavs), jnp.asarray(lens))
    return np.asarray(jnp.asarray(hs, jnp.float32)), np.asarray(h_lens)


def port_model(pos, v, precision="f32", quantize=False):
    cfg = configs(pos)[1]
    model = Wav2Vec2Trunk(cfg, dtype=DTYPES[precision][1], quantize=quantize, device="meta")
    model.to_empty(device="cpu")
    model.load_state_dict(trunk_state_dict_from_jax(v, cfg))
    return TrunkUpstream(name="tiny", model=model.eval(), num_layers=3, hidden_size=128,
                         downsample_rate=STRIDE)


@pytest.mark.parametrize("T", [1, 2, 7, 50])
def test_rel_shift_and_table_match_jax(T):
    """The sinusoid table [2T-1, d] and the shift of [B, H, T, 2T-1] scores
    bit for bit."""
    table = port_transformer.relative_positional_table(T, 64)
    np.testing.assert_array_equal(table.numpy(), jax_transformer.relative_positional_table(T, 64))
    x = np.random.RandomState(T).randn(2, 3, T, 2 * T - 1).astype(np.float32)
    got = port_transformer._rel_shift(torch.from_numpy(x))
    assert tuple(got.shape) == (2, 3, T, T)
    np.testing.assert_array_equal(got.numpy(), np.asarray(jax_transformer._rel_shift(x)))


def test_tables_cached_in_inference_mode_serve_autograd():
    """The relative-position and rotary tables first cached under
    `Upstream.apply_standardized`'s inference mode are ordinary tensors,
    which a forward that autograd records can save."""
    with torch.inference_mode():
        tables = (port_transformer.relative_positional_table(13, 64),
                  port_transformer._rotary_tables(13, 64, torch.device("cpu")))
    w = torch.randn(64, 64, requires_grad=True)
    for table in tables:
        assert not table.is_inference()
        (table @ w).sum().backward()


@pytest.mark.parametrize("pos,precision,quantize", [
    ("rel_pos", "f32", False), ("rope", "f32", False), ("abs", "f32", False),
    ("rel_pos", "bf16", False), ("rope", "bf16", False), ("rope", "f32", True)])
def test_conformer_matches_jax(variables, pos, precision, quantize):
    """Every valid frame in f32 (utterances with no frame included: both
    give their attention rows the mean of the values); bf16 per-layer
    cosines. ``quantize`` takes effect in the extractor only (tanh GELU,
    which K3's plain version runs here), as JAX's trunk hands it there."""
    wavs, lens = _batch(60, LENS)
    want, want_lens = run_jax(pos, variables[pos], wavs, lens, precision, quantize)
    up = port_model(pos, variables[pos], precision, quantize)
    assert up.model.feature_extractor.quantize == quantize
    got, got_lens = run_port(up, wavs, lens)
    assert got.shape == (3, 6, 30, 128)
    if precision == "f32":
        assert_f32_close(got, want, got_lens, want_lens)
    else:
        np.testing.assert_array_equal(got_lens, want_lens)
        coss = _layer_cosines(got, want, got_lens)
        assert min(coss) > 0.999, coss


@pytest.mark.parametrize("pos", ["rel_pos", "rope"])
def test_apply_weighted_matches_jax(variables, pos):
    """`TrunkUpstream.apply_weighted` against the JAX trunk's fused
    weighted sum (its ``layer_weights`` scan): [1, B, T', C] over the
    valid frames at atol 5e-4, the same raw lengths."""
    wavs, lens = _batch(61, LENS)
    w = np.asarray([0.2, -0.5, 1.3], np.float32)
    want, want_lens = jax_apply(pos)(variables[pos], jnp.asarray(wavs), jnp.asarray(lens),
                                     jnp.asarray(w))
    got, got_lens = port_model(pos, variables[pos]).apply_weighted(w, wavs, lens)
    np.testing.assert_array_equal(got_lens.numpy(), np.asarray(want_lens))
    assert tuple(got.shape) == np.shape(want) == (1, 6, 29, 128)
    for b, n in enumerate(np.asarray(want_lens)):
        np.testing.assert_allclose(got[0, b, :n].numpy(), np.asarray(want)[0, b, :n], atol=5e-4)


def reference_checkpoint(pos, variables):
    """An s3prl checkpoint of the tiny Conformer in fairseq's layout: the
    trunk's keys, the pos-conv the reference encoder holds but never
    applies (weight norm), the BatchNorm's batch counter, and the head the
    loaders leave out."""
    sd = trunk_state_dict_from_jax(variables[pos], configs(pos)[1])
    sd.update({"encoder.pos_conv.0.weight_g": torch.ones(1, 1, 16),
               "encoder.pos_conv.0.weight_v": torch.randn(128, 8, 16),
               "encoder.pos_conv.0.bias": torch.zeros(128), "final_proj.weight": torch.ones(4)})
    for i in range(2):
        sd[f"encoder.layers.{i}.conv_module.batch_norm.num_batches_tracked"] = torch.tensor(7)
    model_cfg = {"_name": "wav2vec2", "layer_type": "conformer", "pos_enc_type": pos,
                 "extractor_mode": "layer_norm", "encoder_layers": 2, "encoder_embed_dim": 128,
                 "encoder_ffn_embed_dim": 256, "encoder_attention_heads": 2,
                 "conv_feature_layers": str(list(CONV)), "depthwise_conv_kernel_size": 7,
                 "dropout": 0.0, "attention_dropout": 0.0, "dropout_input": 0.0}
    return {"model_weight": sd, "model_cfg": model_cfg, "task_cfg": {"normalize": True}}


@pytest.mark.parametrize("pos", ["rel_pos", "rope"])
def test_checkpoint_loads_the_same_in_both(variables, tmp_path, pos):
    """`hub.load("wav2vec2_conformer[_rope]", ckpt=...)` of a reference-layout
    checkpoint: both packages read the same configuration (the tiny one,
    field for field) and the same variables (the BatchNorm statistics
    included; the pos-conv dropped), and the port's states equal JAX's on
    them at f32."""
    path = tmp_path / "conformer.pt"
    torch.save(reference_checkpoint(pos, variables), path)
    name = "wav2vec2_conformer" if pos == "rel_pos" else "wav2vec2_conformer_rope"
    jup = jax_hub.load(name, ckpt=str(path))
    flat = dict(jax.tree_util.tree_leaves_with_path(variables[pos]))
    loaded = jax.tree_util.tree_leaves_with_path(jup.params)
    assert [p for p, _ in loaded] == list(flat)
    for p, leaf in loaded:
        np.testing.assert_array_equal(np.asarray(leaf), flat[p], err_msg=str(p))
    up = hub.load(name, ckpt=str(path), device="cpu")
    assert dataclasses.asdict(up.model.cfg) == dataclasses.asdict(configs(pos)[0])
    wavs, lens = _batch(62, LENS)
    want, want_lens = run_jax(pos, jup.params, wavs, lens)
    got, got_lens = run_port(up, wavs, lens)
    assert_f32_close(got, want, got_lens, want_lens)


def test_entries_build_the_jax_configuration(monkeypatch):
    """Both conformer entries' full configurations equal the JAX entries'
    (their factories' configs captured) and the names reach them."""
    captured = {}
    monkeypatch.setattr(jax_registry, "_trunk_upstream",
                        lambda name, cfg, **kw: captured.setdefault(name, cfg))
    monkeypatch.setattr(port_registry, "_trunk_upstream",
                        lambda name, cfg, **kw: captured.setdefault("port " + name, cfg))
    for name in ("wav2vec2_conformer", "wav2vec2_conformer_relpos", "wav2vec2_conformer_rope"):
        jax_registry.load(name)
        hub.load(name)
    assert set(captured) == {"wav2vec2_conformer", "wav2vec2_conformer_rope",
                             "port wav2vec2_conformer", "port wav2vec2_conformer_rope"}
    for name in ("wav2vec2_conformer", "wav2vec2_conformer_rope"):
        assert dataclasses.asdict(captured["port " + name]) == dataclasses.asdict(captured[name])
    assert captured["port wav2vec2_conformer_rope"].pos_enc_type == "rope"


def test_refusals(variables, monkeypatch):
    """flash=True and the pos-conv options raise at load (JAX ignores
    use_flash on conformer layers; the encoder has no pos-conv); train mode
    raises where JAX's does: its BatchNorm would update ``batch_stats``,
    which the trainer hands over immutable."""
    monkeypatch.setattr(port_registry, "CONFORMER_BASE", configs("rel_pos")[1])
    for kw, match in (({"flash": True}, "conformer layers"),
                      ({"fused_posconv": True}, "no pos-conv"),
                      ({"int8_posconv": True}, "no pos-conv")):
        with pytest.raises(ValueError, match=match):
            hub.load("wav2vec2_conformer", device="cpu", **kw)
    wavs, lens = _batch(63, [3200, 1600])
    model = JaxTrunk(configs("rel_pos")[0])
    with pytest.raises(flax.errors.ModifyScopeVariableError, match="batch_stats"):
        jax.jit(lambda v, w, n: model.apply(v, w, n, deterministic=False,
                                            rngs={"dropout": jax.random.key(1)}))(
            variables["rel_pos"], jnp.asarray(wavs), jnp.asarray(lens))
    up = hub.load("wav2vec2_conformer", device="cpu")
    with pytest.raises(NotImplementedError, match="batch_stats"):
        up(torch.from_numpy(wavs), torch.from_numpy(lens), train=True,
           generator=torch.Generator().manual_seed(0))
    hs, _ = up(torch.from_numpy(wavs), torch.from_numpy(lens))
    assert tuple(hs.shape) == (3, 2, 10, 128) and bool(torch.isfinite(hs).all())
