"""LightHuBERT and MR-HuBERT of s3prl_tpu_torch vs s3prl_tpu (CPU).

Tiny models of each (the seven-layer conv stack at 64 channels; C 128,
head dim 64) get JAX param trees drawn with numpy (`jax_init`), carried
to the port with `lighthubert_state_dict_from_jax` /
`multires_hubert_state_dict_from_jax`; the same numpy batch goes through
`Upstream.apply_standardized` of both: f32 per-layer states within atol
5e-4 over the valid frames, bf16 per-layer cosine > 0.999. MR-HuBERT runs
its `ConvAdapter` U-net (one rate pair) and the plain halves (two pairs,
per-block depths). The checkpoints in the reference layouts go through
both registries: a LightHuBERT supernet (C 128, FFN 512: four FFN blocks)
sliced to a subnet by each package (the published subnets patched to tiny
ones in both: a pruner's 64 / FFN 128 - the first 64 rows of each of two
blocks - and a student's largest), and an s3prl MR-HuBERT checkpoint.
MR-HuBERT's train mode runs each dropout site at rate 1.0 (zeros in both
packages, whatever their streams) against JAX's.
"""

import dataclasses

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

import s3prl_tpu.models.lighthubert as jax_lighthubert
import s3prl_tpu.models.multires_hubert as jax_multires
import s3prl_tpu_torch.kernels.conv_frontend as port_cf
import s3prl_tpu_torch.upstream.convert as port_convert
import s3prl_tpu_torch.upstream.registry as port_registry
from s3prl_tpu import hub as jax_hub
from s3prl_tpu.upstream.base import Upstream as JaxUpstream
from s3prl_tpu.upstream.convert import load_lighthubert_checkpoint as jax_load_lighthubert
from s3prl_tpu_torch import hub
from s3prl_tpu_torch.models.lighthubert import LightHubertConfig, LightHubertModel
from s3prl_tpu_torch.models.multires_hubert import MultiresHubertConfig, MultiresHubertModel
from s3prl_tpu_torch.upstream.base import Upstream
from s3prl_tpu_torch.upstream.convert import (lighthubert_state_dict_from_jax,
                                              multires_hubert_state_dict_from_jax)
from test_torch_port_mel_ssl import perturb
from test_torch_port_slice import _batch, _jax_defaults, _layer_cosines  # noqa: F401 (fixture)
from test_torch_port_w2v2 import CONV, LENS, assert_f32_close, run_port
from test_torch_port_zoo_trunks import run_jax_up, weight_norm

LIGHT = dict(conv_feature_layers=CONV, embed_dim=128, num_heads=2, ffn_dim=256, num_layers=2,
             conv_pos=16, conv_pos_groups=4)
MR = {"adapter": dict(conv_feature_layers=CONV, encoder_embed_dim=128, encoder_ffn_embed_dim=256,
                      encoder_attention_heads=2, conv_pos=16, conv_pos_groups=4, dropout=0.0,
                      attention_dropout=0.0, dropout_input=0.0, encoder_layers=1),
      "plain": dict(conv_feature_layers=CONV, encoder_embed_dim=128, encoder_ffn_embed_dim=256,
                    encoder_attention_heads=2, conv_pos=16, conv_pos_groups=4, dropout=0.0,
                    attention_dropout=0.0, dropout_input=0.0, use_plain_updownsample=True,
                    label_rate_ratios=(1, 2, 1, 2), override_encoder_layers=(1, 2, 1, 1, 2))}
DTYPES = {"f32": (jnp.float32, torch.float32), "bf16": (jnp.bfloat16, torch.bfloat16)}


def jax_init(model, seed):
    """The JAX model's param tree (its shapes traced, not compiled) drawn
    with numpy: kernels N(0, 1 / fan_in), norm scales 1 + 0.05 N(0, 1),
    every other leaf 0.05 N(0, 1)."""
    shapes = jax.eval_shape(lambda k: model.init(k, jnp.zeros((1, 3200)), jnp.asarray([3200]),
                                                 deterministic=True), jax.random.key(0))
    rng = np.random.RandomState(seed)

    def draw(path, leaf):
        x = rng.randn(*leaf.shape).astype(np.float32)
        name = path[-1].key
        if name == "kernel":
            return x / np.sqrt(np.prod(leaf.shape[:-1]))
        return 1.0 + 0.05 * x if name == "scale" else 0.05 * x

    return jax.tree_util.tree_map_with_path(draw, shapes["params"])


@pytest.fixture(scope="module")
def params():
    out = {"light": jax_init(jax_lighthubert.LightHubertModel(
        jax_lighthubert.LightHubertConfig(**LIGHT)), 0)}
    for case, kw in MR.items():
        out[case] = jax_init(jax_multires.MultiresHubertModel(
            jax_multires.MultiresHubertConfig(**kw)), 1)
    return out


def both(case, params, precision):
    """(the JAX upstream, the port's) of `case` on the same weights."""
    jdtype, dtype = DTYPES[precision]
    if case == "light":
        jmodel = jax_lighthubert.LightHubertModel(jax_lighthubert.LightHubertConfig(**LIGHT),
                                                  dtype=jdtype)
        cfg = LightHubertConfig(**LIGHT)
        model, convert, L = LightHubertModel(cfg, dtype, "meta"), lighthubert_state_dict_from_jax, 3
    else:
        jmodel = jax_multires.MultiresHubertModel(jax_multires.MultiresHubertConfig(**MR[case]),
                                                  dtype=jdtype)
        cfg = MultiresHubertConfig(**MR[case])
        model, convert = MultiresHubertModel(cfg, dtype, "meta"), multires_hubert_state_dict_from_jax
        L = cfg.num_hidden_states
    apply = jax.jit(lambda p, w, n: jmodel.apply({"params": p}, w, n, deterministic=True))
    jup = JaxUpstream(name=case, params=params[case],
                      apply_fn=lambda p, w, n, train, rngs: apply(p, w, n), num_layers=L,
                      hidden_size=128, downsample_rate=320)
    model.to_empty(device="cpu")
    model.load_state_dict(convert(params[case], cfg))
    return jup, Upstream(case, model.eval(), L, 128, 320)


@pytest.mark.parametrize("case,precision", [("light", "f32"), ("light", "bf16"),
                                            ("adapter", "f32"), ("adapter", "bf16"),
                                            ("plain", "f32")])
def test_matches_jax(params, monkeypatch, case, precision):
    """Every state at f32 within 5e-4 (bf16 per-layer cosine > 0.999);
    LightHuBERT's extractor takes K3's wrapper (its plain version here)
    once, MR-HuBERT's group-norm one none."""
    calls = []
    conv0 = port_cf.conv0_ln_gelu_reference
    monkeypatch.setattr(port_cf, "conv0_ln_gelu_reference",
                        lambda *a, **k: calls.append(1) or conv0(*a, **k))
    jup, up = both(case, params, precision)
    wavs, lens = _batch(80, LENS)
    hs, h_lens = jup.apply_standardized(jup.params, jnp.asarray(wavs), jnp.asarray(lens))
    want, want_lens = np.asarray(jnp.asarray(hs, jnp.float32)), np.asarray(h_lens)
    got, got_lens = run_port(up, wavs, lens)
    assert got.shape[0] == up.num_layers and got.shape[1:] == (6, 30, 128)
    assert len(calls) == (case == "light")
    if precision == "f32":
        assert_f32_close(got, want, got_lens, want_lens)
    else:
        np.testing.assert_array_equal(got_lens, want_lens)
        coss = _layer_cosines(got, want, got_lens)
        assert min(coss) > 0.999, coss


SUPERNET = LightHubertConfig(conv_feature_layers=CONV, embed_dim=128, num_heads=2, ffn_dim=512,
                             num_layers=2, conv_pos=16, conv_pos_groups=4)
TINY_SUBNETS = {"SUBNET_SMALL": {"embed_dim": 64, "heads_num": 1, "ffn_embed": 128,
                                 "layer_num": 2},
                "SUBNET_SMALL_MAX": {"embed_dim": 128, "heads_num": 2, "ffn_embed": 512,
                                     "layer_num": 2}}


@pytest.mark.parametrize("kind,subnet", [("hubert_pruner", "SUBNET_SMALL"),
                                         ("student_hubert", "SUBNET_SMALL_MAX")])
def test_lighthubert_checkpoint_slices_like_jax(tmp_path, monkeypatch, kind, subnet):
    """A supernet checkpoint ``{"cfg": {"model"}, "model"}`` through both
    registries' ``lighthubert_small``: the same subnet config and, from the
    host-side slicing of each package, f32 states within 5e-4."""
    for name, value in TINY_SUBNETS.items():
        monkeypatch.setattr(jax_lighthubert, name, value)
        monkeypatch.setattr(port_convert, name, value)
    model = LightHubertModel(SUPERNET, device="meta")
    model.to_empty(device="cpu")
    port_registry._init_trunk(model, torch.Generator().manual_seed(6))
    sd = perturb(model.state_dict(), 6)
    weight_norm(sd, "encoder.pos_conv.0")
    model_cfg = {"_name": kind, "pruner_supernet": "configs/small.yaml",
                 "supernet_type": "small", "conv_feature_layers": str(list(CONV)),
                 "conv_pos": 16, "conv_pos_groups": 4}
    path = tmp_path / "lighthubert.pt"
    torch.save({"cfg": {"model": model_cfg}, "model": sd}, path)
    up = hub.load("lighthubert_small", ckpt=str(path), device="cpu")
    jax_cfg, _ = jax_load_lighthubert(str(path))
    assert dataclasses.asdict(up.model.cfg) == dataclasses.asdict(jax_cfg)
    assert up.model.cfg.embed_dim == TINY_SUBNETS[subnet]["embed_dim"]
    jup = jax_hub.load("lighthubert_small", ckpt=str(path))
    wavs, lens = _batch(81, LENS)
    want, want_lens = run_jax_up(jup, wavs, lens)
    got, got_lens = run_port(up, wavs, lens)
    assert got.shape == (3, 6, 30, TINY_SUBNETS[subnet]["embed_dim"])
    assert_f32_close(got, want, got_lens, want_lens)


def test_multires_checkpoint_matches_jax(params, tmp_path):
    """An s3prl MR-HuBERT checkpoint (the plain halves, two pairs, per-block
    depths as a string; the first encoder's pos-conv under weight norm)
    through both registries: the same config, f32 states within 5e-4."""
    cfg = MultiresHubertConfig(**MR["plain"])
    sd = multires_hubert_state_dict_from_jax(params["plain"], cfg)
    weight_norm(sd, "encoders.0.pos_conv.0")
    model_cfg = {"conv_feature_layers": str(list(CONV)), "encoder_embed_dim": 128,
                 "encoder_ffn_embed_dim": 256, "encoder_attention_heads": 2, "conv_pos": 16,
                 "conv_pos_groups": 4, "label_rate_ratios": [1, 2, 1, 2],
                 "override_encoder_layers": "[1, 2, 1, 1, 2]", "use_plain_updownsample": True,
                 "dropout": 0.0, "attention_dropout": 0.0, "dropout_input": 0.0}
    path = tmp_path / "mr.pt"
    torch.save({"model_weight": sd, "model_cfg": model_cfg, "task_cfg": {}}, path)
    up = hub.load("multires_hubert_base", ckpt=str(path), device="cpu")
    assert dataclasses.asdict(up.model.cfg) == dataclasses.asdict(cfg)
    assert up.num_layers == cfg.num_hidden_states == 12
    jup = jax_hub.load("multires_hubert_base", ckpt=str(path))
    wavs, lens = _batch(82, LENS)
    want, want_lens = run_jax_up(jup, wavs, lens)
    got, got_lens = run_port(up, wavs, lens)
    assert_f32_close(got, want, got_lens, want_lens)


@pytest.mark.parametrize("name", ["lighthubert", "lighthubert_small", "multires_hubert",
                                  "multires_hubert_multilingual_large600k"])
def test_refusals(name):
    """flash / quantize raise at load (the JAX entries take and ignore
    them); the default configurations are the JAX ones."""
    for kw in ({"flash": True}, {"quantize": True}):
        with pytest.raises(ValueError, match="cannot take effect on"):
            hub.load(name, device="cpu", **kw)
    if name.startswith("lighthubert"):
        subnet = (port_registry.SUBNET_SMALL if name.endswith("small")
                  else port_registry.SUBNET_BASE)
        want = jax_lighthubert.SUBNET_SMALL if name.endswith("small") else \
            jax_lighthubert.SUBNET_BASE
        assert subnet == want
    else:
        assert (dataclasses.asdict(MultiresHubertConfig())
                == dataclasses.asdict(jax_multires.MultiresHubertConfig()))


@pytest.mark.parametrize("site", ["dropout_input", "dropout", "activation_dropout"])
def test_multires_dropout_site_matches_jax(params, site):
    """MR-HuBERT's train mode with one rate at 1.0 (the others 0), which
    zeroes its site in both packages whatever their streams: every state
    equals JAX's, and differs from eval mode's."""
    fields = {**MR["adapter"], site: 1.0}
    jmodel = jax_multires.MultiresHubertModel(jax_multires.MultiresHubertConfig(**fields))
    run = jax.jit(lambda p, w, n: jmodel.apply({"params": p}, w, n, deterministic=False,
                                               rngs={"dropout": jax.random.key(3)}))
    wavs, lens = _batch(83, LENS[:3])
    want, want_lens = run(params["adapter"], jnp.asarray(wavs), jnp.asarray(lens))
    cfg = MultiresHubertConfig(**fields)
    model = MultiresHubertModel(cfg, device="meta")
    model.to_empty(device="cpu")
    model.load_state_dict(multires_hubert_state_dict_from_jax(params["adapter"], cfg))
    with torch.no_grad():
        got, got_lens = model.train()(torch.from_numpy(wavs), torch.from_numpy(lens),
                                      generator=torch.Generator().manual_seed(0))
        evaluated, _ = model.eval()(torch.from_numpy(wavs), torch.from_numpy(lens))
    np.testing.assert_array_equal(got_lens.numpy(), np.asarray(want_lens))
    for b, n in enumerate(np.asarray(want_lens)):
        np.testing.assert_allclose(got[:, b, :n].numpy(), np.asarray(want)[:, b, :n], atol=5e-4)
    assert not torch.allclose(got, evaluated, atol=1e-3)
