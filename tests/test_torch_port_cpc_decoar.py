"""CPC, DeCoAR 1 (and decoar_layers) and DeCoAR 2.0 of s3prl_tpu_torch vs
s3prl_tpu (CPU).

Each JAX entry's random params, every leaf perturbed, go to the port
through its `*_state_dict_from_jax`, and both registries' upstreams run
the same padded batch: CPC at 32 wide in its LSTM, GRU and tanh-RNN modes
(flax's recurrences run on over the padded frames, so every frame is
compared), DeCoAR at hidden 32 (the backward stack reversed within each
row's valid frames), DeCoAR 2.0 at two layers of its 768-wide encoder in
f32 and bf16. The JAX classes are patched with tiny defaults, as the
port's registry constants. Tolerances: every hidden state at atol 5e-4 in
f32, per-layer cosine > 0.999 over the valid frames in bf16, lengths
equal. The checkpoints are the reference's layouts written from the
port's weights, with each LSTM's bias split over its two torch biases.
"""

import copy

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

import s3prl_tpu.models.cpc as jax_cpc
import s3prl_tpu.models.decoar as jax_decoar
import s3prl_tpu.models.decoar2 as jax_decoar2
import s3prl_tpu_torch.upstream.registry as port_registry
from s3prl_tpu import hub as jax_hub
from s3prl_tpu.upstream import convert as jax_convert
from s3prl_tpu_torch import hub
from s3prl_tpu_torch.models.cpc import CPCConfig
from s3prl_tpu_torch.models.decoar import Decoar2Config, DecoarConfig
from s3prl_tpu_torch.upstream.convert_zoo import (cpc_state_dict_from_jax,
                                                  decoar2_state_dict_from_jax,
                                                  decoar_state_dict_from_jax)
from test_torch_port_mel_ssl import same_trees, with_defaults
from test_torch_port_wav2vec1 import LENS, layer_cosines, waves


def perturbed(tree, seed=0):
    """Every leaf + 0.05 N(0, 1), as numpy f32."""
    rng = np.random.RandomState(seed)
    return jax.tree_util.tree_map(
        lambda x: np.asarray(x, np.float32) + 0.05 * rng.randn(*np.shape(x)).astype(np.float32),
        tree)


_JAX_UPSTREAMS = {}


def jax_upstream(name, dtype=None):
    """The JAX entry at the patched configuration, its random init made
    once per configuration."""
    key = (name, dtype, repr(jax_cpc.CPCConfig()), jax_decoar.DecoarModel,
           jax_decoar2.Decoar2Model)
    if key not in _JAX_UPSTREAMS:
        _JAX_UPSTREAMS[key] = jax_hub.load(name, **({} if dtype is None else {"dtype": dtype}))
    return copy.copy(_JAX_UPSTREAMS[key])


def run_both(name, jax_params, port_sd, dtype=None):
    """Both entries on the same weights and batch -> (port, JAX) states and
    lengths."""
    jup = jax_upstream(name, None if dtype is None else dtype[1])
    up = hub.load(name, device="cpu", **({} if dtype is None else {"dtype": dtype[0]}))
    up.model.load_state_dict(port_sd)
    x = waves()
    want, want_lens = jax.jit(jup.apply_standardized)(jax_params, jnp.asarray(x),
                                                      jnp.asarray(LENS))
    got, got_lens = up(torch.from_numpy(x), torch.from_numpy(LENS))
    np.testing.assert_array_equal(got_lens.numpy(), np.asarray(want_lens))
    # the JAX entries' layer counts and widths are their published models'
    assert (up.num_layers, up.hidden_size, up.downsample_rate) == (
        got.shape[0], got.shape[-1], jup.downsample_rate)
    return up, got, np.asarray(want), got_lens.tolist()


def same_outputs(jup, up, seed):
    """Both upstreams' standardized states on one batch at atol 5e-4."""
    x = waves(seed=seed)
    want, want_lens = jax.jit(jup.__call__)(jnp.asarray(x), jnp.asarray(LENS))
    got, got_lens = up(torch.from_numpy(x), torch.from_numpy(LENS))
    np.testing.assert_array_equal(got_lens.numpy(), np.asarray(want_lens))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=5e-4, rtol=0)


# -- CPC --------------------------------------------------------------------------

CPC_MODES = {"lstm": 1, "gru": 2, "rnn": 2}  # ar_mode -> ar_layers


@pytest.fixture
def tiny_cpc(monkeypatch, request):
    mode = request.param
    fields = dict(hidden_size=32, ar_size=32, ar_layers=CPC_MODES[mode], ar_mode=mode)
    monkeypatch.setattr(jax_cpc, "CPCConfig", with_defaults(jax_cpc.CPCConfig, **fields))
    monkeypatch.setattr(port_registry, "CPC", CPCConfig(**fields))
    return CPCConfig(**fields)


@pytest.mark.parametrize("tiny_cpc", list(CPC_MODES), indirect=True)
def test_cpc_matches_jax(tiny_cpc):
    """z and c on every frame; the LSTM / GRU trees back through the JAX
    converter bit for bit (its biases folded as the port holds them)."""
    params = perturbed(jax_upstream("cpc").params)
    sd = cpc_state_dict_from_jax(params, tiny_cpc)
    up, got, want, _ = run_both("cpc", params, sd)
    assert got.shape == (2, len(LENS), want.shape[2], 32)
    np.testing.assert_allclose(got.numpy(), want, atol=5e-4, rtol=0)
    if tiny_cpc.ar_mode != "rnn":  # the JAX converter maps LSTM and GRU layers
        same_trees(jax_convert.cpc_params_from_torch(sd, tiny_cpc), params)
    got_train, _ = up(torch.from_numpy(waves()), torch.from_numpy(LENS), train=True)
    assert torch.equal(got_train, got)  # no dropout: train mode is eval mode, as in JAX


def split_biases(sd, keys, seed=0):
    """A torch checkpoint's view of flax's one LSTM bias: ``bias_ih`` random,
    ``bias_hh`` the rest."""
    rng = np.random.RandomState(seed)
    out = dict(sd)
    for ih in keys:
        hh = ih.replace("bias_ih", "bias_hh")
        r = torch.from_numpy(rng.randn(*sd[ih].shape).astype(np.float32))
        out[ih], out[hh] = r, sd[hh] + sd[ih] - r
    return out


@pytest.mark.parametrize("tiny_cpc", ["lstm", "gru"], indirect=True)
def test_cpc_checkpoint_round_trip(tmp_path, tiny_cpc):
    """{"config", "weights"} with the biases split over both torch biases
    (GRU: the r / z biases): both loaders fold them to the same states."""
    params = perturbed(jax_upstream("cpc").params, seed=1)
    sd = cpc_state_dict_from_jax(params, tiny_cpc)
    sd = split_biases(sd, [k for k in sd if "bias_ih" in k])
    path = tmp_path / "cpc.pt"
    config = {"hiddenEncoder": 32, "hiddenGar": 32, "nLevelsGRU": tiny_cpc.ar_layers,
              "arMode": tiny_cpc.ar_mode.upper()}
    torch.save({"config": config, "weights": sd}, path)
    jup = jax_hub.load("cpc_local", ckpt=str(path))
    up = hub.load("cpc_local", ckpt=str(path), device="cpu")
    assert up.model.cfg == tiny_cpc
    same_outputs(jup, up, seed=2)


@pytest.mark.parametrize("tiny_cpc", ["rnn"], indirect=True)
def test_cpc_rnn_checkpoint_refused(tmp_path, tiny_cpc):
    """An arMode RNN checkpoint: the JAX loader reads it through the GRU
    layout and its model cannot apply it; the port refuses it at load."""
    sd = cpc_state_dict_from_jax(perturbed(jax_upstream("cpc").params), tiny_cpc)
    path = tmp_path / "cpc_rnn.pt"
    torch.save({"config": {"hiddenEncoder": 32, "hiddenGar": 32, "nLevelsGRU": 2,
                           "arMode": "RNN"}, "weights": sd}, path)
    jup = jax_hub.load("cpc", ckpt=str(path))
    with pytest.raises(Exception):
        jax.jit(jup.__call__)(jnp.asarray(waves()), jnp.asarray(LENS))
    with pytest.raises(ValueError, match="arMode RNN"):
        hub.load("cpc", ckpt=str(path), device="cpu")


# -- DeCoAR 1 -------------------------------------------------------------------------


class TinyDecoar(jax_decoar.DecoarModel):
    hidden: int = 32


@pytest.fixture
def tiny_decoar(monkeypatch):
    monkeypatch.setattr(jax_decoar, "DecoarModel", TinyDecoar)
    monkeypatch.setattr(port_registry, "DECOAR", DecoarConfig(hidden=32))


@pytest.mark.parametrize("name", ["decoar", "decoar_layers"])
def test_decoar_matches_jax(tiny_decoar, name):
    """The last layer's (decoar) or every layer's (decoar_layers)
    [forward; backward] on every frame; train mode is eval mode, as in JAX."""
    params = perturbed(jax_upstream(name).params)
    sd = decoar_state_dict_from_jax(params)
    up, got, want, _ = run_both(name, params, sd)
    assert got.shape == (4 if name == "decoar_layers" else 1, len(LENS), want.shape[2], 64)
    np.testing.assert_allclose(got.numpy(), want, atol=5e-4, rtol=0)
    same_trees(jax_convert.decoar_params_from_torch(sd), params)
    # the JAX entry's apply_fn hands the model no train flag (registry.py:1003-1007)
    got_train, _ = up(torch.from_numpy(waves()), torch.from_numpy(LENS), train=True)
    assert torch.equal(got_train, got)


def decoar_layout(sd):
    """decoar's keys: one 4-layer forward_lstm / backward_lstm."""
    out = {}
    for k, v in sd.items():
        if k.startswith(("forward_lstms.", "backward_lstms.")):
            direction, i, kind = k.split(".")
            k = f"{direction[:-1]}.{kind[:-1]}{i}"
        out[k] = v
    return out


@pytest.mark.parametrize("layout", ["decoar", "decoar_layers"])
def test_decoar_checkpoint_round_trip(tmp_path, tiny_decoar, layout):
    """{"model"} in decoar's keys or decoar_layers', the LSTM biases split:
    both loaders give the same states."""
    params = perturbed(jax_upstream("decoar").params, seed=1)
    sd = decoar_state_dict_from_jax(params)
    sd = split_biases(sd, [k for k in sd if "bias_ih" in k])
    path = tmp_path / "decoar.ckpt"
    torch.save({"model": decoar_layout(sd) if layout == "decoar" else sd}, path)
    name = {"decoar": "decoar_custom", "decoar_layers": "decoar_layers_local"}[layout]
    jup = jax_hub.load(name, ckpt=str(path))
    up = hub.load(name, ckpt=str(path), device="cpu")
    same_outputs(jup, up, seed=2)


# -- DeCoAR 2.0 -------------------------------------------------------------------------


class TinyDecoar2(jax_decoar2.Decoar2Model):
    num_layers: int = 2


@pytest.fixture
def tiny_decoar2(monkeypatch):
    monkeypatch.setattr(jax_decoar2, "Decoar2Model", TinyDecoar2)
    monkeypatch.setattr(port_registry, "DECOAR2", Decoar2Config(num_layers=2))


def decoar2_params(seed=0):
    return perturbed(jax_upstream("decoar2").params, seed)


def test_decoar2_matches_jax(tiny_decoar2):
    """f32: the three states at 5e-4; the JAX layers back through its
    converter bit for bit."""
    params = decoar2_params()
    sd = decoar2_state_dict_from_jax(params)
    _, got, want, _ = run_both("decoar2", params, sd)
    assert got.shape == (3, len(LENS), want.shape[2], 768)
    np.testing.assert_allclose(got.numpy(), want, atol=5e-4, rtol=0)
    w = sd["encoder.pos_conv.0.weight"]  # the JAX converter reads the weight norm's pair
    back = jax_convert.decoar2_params_from_torch(
        {**sd, "encoder.pos_conv.0.weight_g": w.norm(dim=(0, 1), keepdim=True),
         "encoder.pos_conv.0.weight_v": w})
    same_trees(back["encoder"]["layers"], params["encoder"]["layers"])


def test_decoar2_bf16_matches_jax(tiny_decoar2):
    """bf16 in both: per-layer cosine > 0.999 over the valid frames."""
    params = decoar2_params(seed=1)
    _, got, want, lens = run_both("decoar2", params, decoar2_state_dict_from_jax(params),
                                  dtype=(torch.bfloat16, jnp.bfloat16))
    assert got.dtype == torch.bfloat16
    coss = layer_cosines(got.float().numpy(), want.astype(np.float32), lens)
    assert min(coss) > 0.999, coss


def test_decoar2_train_mode(tiny_decoar2, monkeypatch):
    """JAX's train mode runs the projection's and the encoder's dropouts
    (0.1) on its "dropout" stream; so does the port's, from its generator:
    it runs and differs from eval. At rate 0 its train-mode path gives the
    JAX eval states."""
    params = decoar2_params(seed=2)
    sd = decoar2_state_dict_from_jax(params)
    up, got, want, _ = run_both("decoar2", params, sd)
    x, lens = torch.from_numpy(waves()), torch.from_numpy(LENS)
    drop, _ = up(x, lens, train=True, generator=torch.Generator().manual_seed(0))
    assert up.model.training and drop.shape == got.shape and bool(torch.isfinite(drop).all())
    assert not torch.allclose(drop, got, atol=1e-3)
    monkeypatch.setattr(port_registry, "DECOAR2", Decoar2Config(num_layers=2, dropout=0.0))
    up = hub.load("decoar2", device="cpu")
    up.model.load_state_dict(sd)
    got_train, _ = up(x, lens, train=True, generator=torch.Generator().manual_seed(0))
    np.testing.assert_allclose(got_train.numpy(), want, atol=5e-4, rtol=0)


def test_decoar2_checkpoint_sizes_from_its_depth(tmp_path, tiny_decoar2):
    """{"model"} in the reference's keys (the pos-conv under weight norm, a
    key neither reads) at three layers: both registries build three layers
    (the entries' default is two here) and give the same states."""
    params = decoar2_params(seed=3)
    layers = params["encoder"]["layers"]
    params["encoder"]["layers"] = jax.tree_util.tree_map(
        lambda x: np.concatenate([x, x[:1] * 0.9]), layers)
    sd = decoar2_state_dict_from_jax(params)
    w = sd.pop("encoder.pos_conv.0.weight")
    g = w.norm(dim=(0, 1), keepdim=True)
    sd.update({"encoder.pos_conv.0.weight_g": g, "encoder.pos_conv.0.weight_v": w * 2.0,
               "mask_emb": torch.zeros(768)})
    path = tmp_path / "decoar2.ckpt"
    torch.save({"model": sd}, path)
    jup = jax_hub.load("decoar2_local", ckpt=str(path))
    up = hub.load("decoar2_local", ckpt=str(path), device="cpu")
    assert up.num_layers == jup.num_layers == 4 and up.model.cfg.num_layers == 3
    same_outputs(jup, up, seed=4)


def test_refusals():
    """The keywords the JAX entries swallow raise at load: dtypes other than
    f32 on CPC and DeCoAR (their JAX factories take none), the trunk options
    on all three (DeCoAR 2.0's message names its 48-channel pos-conv groups)."""
    for name in ("cpc", "modified_cpc", "decoar", "decoar_layers"):
        with pytest.raises(ValueError, match="runs in f32"):
            hub.load(name, dtype=torch.bfloat16, device="cpu")
        with pytest.raises(ValueError, match="quantize cannot take effect"):
            hub.load(name, quantize=True, device="cpu")
    with pytest.raises(ValueError, match="48 a group"):
        hub.load("decoar2", fused_posconv=True, device="cpu")
    with pytest.raises(ValueError, match="use_flash"):
        hub.load("decoar2", flash=True, device="cpu")
    with pytest.raises(ValueError, match="f32 or bf16"):
        hub.load("decoar2", dtype=torch.float16, device="cpu")
    with pytest.raises(TypeError, match="unexpected"):
        hub.load("cpc", model_config="x.yaml", device="cpu")
    with pytest.raises(ValueError, match="requires ckpt"):
        hub.load("decoar2_custom", device="cpu")
