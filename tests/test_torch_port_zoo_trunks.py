"""ESPnet HuBERT and DistilHuBERT of s3prl_tpu_torch vs s3prl_tpu (CPU), and
the load rules of the zoo's 25 new names.

ESPnet: a tiny trunk (the seven-layer conv stack at 64 channels, two
layers at C 128, H 2) of each ESPnet form - base-like (group-norm
extractor, post-LN) and large-like (layer-norm extractor, pre-LN) - is
drawn from a seed, every tensor perturbed, renamed into torchaudio's keys
(the pos-conv under weight norm) inside an espnet2 ``.pth`` with a
config.yaml, and loaded by both registries (`hub.load(..., ckpt=,
model_config=)`); their configurations agree field for field and their
layer outputs (L states, no input entry) at f32 within atol 5e-4 over the
valid frames. The large-like form also runs bf16 with ``flash=True`` on
the kernel route: JAX's K4 / K5 (and K3) in interpret mode, the port's
wrappers (their plain versions on CPU tensors) spied on, per-layer cosine
> 0.999. DistilHuBERT: a tiny JAX model (two layers at C 128, three
prediction heads) perturbed and carried over with
`distiller_state_dict_from_jax`, f32 at atol 5e-4 and bf16 at cosine
0.999 over its 1 + L + n_tasks states; its pretraining checkpoint through
both registries; its train mode with one dropout site at rate 1.0 (zeros in
both packages, whatever their streams) against JAX's.
"""

import dataclasses

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

import s3prl_tpu.models.distiller as jax_distiller
import s3prl_tpu.models.transformer as jax_transformer
import s3prl_tpu.upstream.registry as jax_registry
import s3prl_tpu_torch.kernels.conv_frontend as port_cf
import s3prl_tpu_torch.kernels.ffn as port_ffn
import s3prl_tpu_torch.kernels.flash_attention as port_fa
import s3prl_tpu_torch.models.transformer as port_transformer
import s3prl_tpu_torch.upstream.registry as port_registry
from s3prl_tpu import hub as jax_hub
from s3prl_tpu.upstream.convert import load_espnet_hubert_checkpoint as jax_load_espnet
from s3prl_tpu_torch import hub
from s3prl_tpu_torch.models.distiller import DistillerConfig, DistillerModel
from s3prl_tpu_torch.models.wav2vec2 import Wav2Vec2Config, Wav2Vec2Trunk
from s3prl_tpu_torch.upstream.base import Upstream
from s3prl_tpu_torch.upstream.convert import distiller_state_dict_from_jax
from test_torch_port_mel_ssl import perturb
from test_torch_port_slice import _batch, _jax_defaults, _layer_cosines  # noqa: F401 (fixture)
from test_torch_port_w2v2 import CONV, LENS, assert_f32_close, framed, run_port

WIDTH = dict(conv_feature_layers=CONV, encoder_layers=2, encoder_embed_dim=128,
             encoder_ffn_embed_dim=256, encoder_attention_heads=2, conv_pos=16,
             conv_pos_groups=4)
ESPNET = {"base": dict(extractor_mode="default", layer_norm_first=False),
          "large": dict(extractor_mode="layer_norm", layer_norm_first=True)}
NEW_NAMES = (
    "wav2vec2_conformer", "wav2vec2_conformer_relpos", "wav2vec2_conformer_rope",
    "espnet_hubert", "espnet_hubert_custom", "espnet_hubert_local", "espnet_hubert_base_iter0",
    "espnet_hubert_base_iter1", "cvhubert", "espnet_hubert_large_gs_ll60k", "wavlablm_ek_40k",
    "wavlablm_mk_40k", "wavlablm_ms_40k", "distilhubert", "distiller", "lighthubert",
    "lighthubert_base", "lighthubert_stage1", "lighthubert_small", "multires_hubert",
    "multires_hubert_base", "multires_hubert_large", "multires_hubert_multilingual_base",
    "multires_hubert_multilingual_large400k", "multires_hubert_multilingual_large600k")
# fairseq's names of a transformer layer's modules -> torchaudio's (the
# inverse of s3prl_tpu_torch.upstream.convert._TORCHAUDIO_LAYER_KEYS)
TORCHAUDIO = {"self_attn.k_proj": "attention.k_proj", "self_attn.v_proj": "attention.v_proj",
              "self_attn.q_proj": "attention.q_proj", "self_attn.out_proj": "attention.out_proj",
              "self_attn_layer_norm": "layer_norm", "fc1": "feed_forward.intermediate_dense",
              "fc2": "feed_forward.output_dense", "final_layer_norm": "final_layer_norm"}


def weight_norm(sd, prefix):
    """``{prefix}.weight`` [out, in, k] as torch's weight_norm(dim=2) pair."""
    w = sd.pop(f"{prefix}.weight")
    sd[f"{prefix}.weight_g"] = w.norm(dim=(0, 1), keepdim=True)
    sd[f"{prefix}.weight_v"] = w


def to_torchaudio(sd, mode):
    """A fairseq-keyed trunk state_dict -> an espnet2 checkpoint's keys
    (torchaudio's Wav2Vec2Model under ``encoder.hubert_pretrain_model.``)."""
    out = {}
    for k, v in sd.items():
        parts = k.split(".")
        if k.startswith("feature_extractor."):
            i, rest = parts[2], ".".join(parts[3:])
            nk = (f"feature_extractor.conv_layers.{i}.conv.{rest[2:]}" if rest.startswith("0.")
                  else f"feature_extractor.conv_layers.{i}.layer_norm.{parts[-1]}")
        elif k.startswith("layer_norm."):
            nk = f"encoder.feature_projection.layer_norm.{parts[-1]}"
        elif k.startswith("post_extract_proj."):
            nk = f"encoder.feature_projection.projection.{parts[-1]}"
        elif k.startswith("encoder.pos_conv.0."):
            nk = f"encoder.transformer.pos_conv_embed.conv.{parts[-1]}"
        elif k.startswith("encoder.layer_norm."):
            nk = f"encoder.transformer.layer_norm.{parts[-1]}"
        elif k.startswith("encoder.layers."):
            nk = (f"encoder.transformer.layers.{parts[2]}."
                  f"{TORCHAUDIO['.'.join(parts[3:-1])]}.{parts[-1]}")
        else:
            assert k == "mask_emb", k
            out["encoder.hubert_pretrain_model.mask_generator.mask_embedding"] = v
            continue
        out[f"encoder.hubert_pretrain_model.wav2vec2.{nk}"] = v
    return out


def espnet_checkpoint(tmp_path, form, seed):
    """(the .pth, its config.yaml) of a perturbed tiny trunk of `form`."""
    cfg = Wav2Vec2Config(**WIDTH, **ESPNET[form])
    model = Wav2Vec2Trunk(cfg, device="meta")
    model.to_empty(device="cpu")
    port_registry._init_trunk(model, torch.Generator().manual_seed(seed))
    sd = perturb(model.state_dict(), seed)
    weight_norm(sd, "encoder.pos_conv.0")
    path, conf = tmp_path / f"{form}.pth", tmp_path / "config.yaml"
    torch.save(to_torchaudio(sd, cfg.extractor_mode), path)
    conf.write_text("encoder_conf:\n  encoder_num_heads: 2\n  encoder_layer_norm_first: "
                    f"{'true' if form == 'large' else 'false'}\n")
    return str(path), str(conf)


def run_jax_up(jup, wavs, lens):
    hs, h_lens = jax.jit(jup.__call__)(jnp.asarray(wavs), jnp.asarray(lens))
    return np.asarray(jnp.asarray(hs, jnp.float32)), np.asarray(h_lens)


@pytest.mark.parametrize("form,name", [("base", "espnet_hubert"),
                                       ("large", "espnet_hubert_large_gs_ll60k")])
def test_espnet_checkpoint_matches_jax(tmp_path, form, name):
    """The espnet2 checkpoint through both registries: the same config
    (weights, config.yaml and the sniffed extractor mode), L layer
    outputs at f32 within 5e-4."""
    path, conf = espnet_checkpoint(tmp_path, form, seed=3)
    up = hub.load(name, ckpt=path, model_config=conf, device="cpu")
    jax_cfg, _ = jax_load_espnet(path, conf)
    assert dataclasses.asdict(up.model.cfg) == dataclasses.asdict(jax_cfg)
    assert up.model.cfg.extractor_mode == ESPNET[form]["extractor_mode"]
    assert (up.num_layers, up.hidden_size) == (2, 128)
    jup = jax_hub.load(name, ckpt=path, model_config=conf)
    wavs, lens = _batch(70, LENS)
    want, want_lens = run_jax_up(jup, wavs, lens)
    got, got_lens = run_port(up, wavs, lens)
    assert got.shape == (2, 6, 30, 128)
    assert_f32_close(got, want, got_lens, want_lens)


def spy(monkeypatch, module, name):
    calls, fn = [], getattr(module, name)
    monkeypatch.setattr(module, name, lambda *a, **k: calls.append(1) or fn(*a, **k))
    return calls


def test_espnet_large_flash_route_matches_jax(tmp_path, monkeypatch):
    """bf16 with flash=True on the kernel route in both packages: K3 once,
    K4 and K5 once a layer (the port's wrappers' plain versions spied on),
    per-layer cosine > 0.999 against JAX's interpreted kernels over the
    utterances with a frame."""
    path, conf = espnet_checkpoint(tmp_path, "large", seed=4)
    monkeypatch.setattr(jax_transformer, "_fused_block_available", lambda: True)
    monkeypatch.setattr(port_transformer, "_fused_block_available", lambda x: True)
    calls = {name: spy(monkeypatch, module, name) for module, name in (
        (port_cf, "conv0_ln_gelu_reference"), (port_fa, "fused_attention_block_bf16_reference"),
        (port_ffn, "fused_bf16_ffn_reference"))}
    kw = dict(ckpt=path, model_config=conf, flash=True)
    up = hub.load("espnet_hubert_large_gs_ll60k", dtype=torch.bfloat16, device="cpu", **kw)
    jup = jax_hub.load("espnet_hubert_large_gs_ll60k", dtype=jnp.bfloat16, **kw)
    wavs, lens = _batch(71, LENS)
    got, got_lens = run_port(up, wavs, lens)
    assert {k: len(v) for k, v in calls.items()} == {
        "conv0_ln_gelu_reference": 1, "fused_attention_block_bf16_reference": 2,
        "fused_bf16_ffn_reference": 2}
    want, want_lens = run_jax_up(jup, wavs, lens)
    np.testing.assert_array_equal(got_lens, want_lens)
    coss = _layer_cosines(got, want, framed(lens, got_lens))
    assert min(coss) > 0.999, coss


def test_espnet_defaults_and_refusals(monkeypatch):
    """The no-checkpoint configurations equal JAX's (HuBERT-Base's and
    -Large's: every name reaches one of the two); quantize and the other
    trunk options raise, as JAX swallows them; unknown keywords are a
    TypeError."""
    captured = {}
    monkeypatch.setattr(jax_registry, "_espnet_hubert_upstream",
                        lambda name, default_cfg=None, **kw: captured.setdefault(name, default_cfg))
    monkeypatch.setattr(port_registry, "_espnet_hubert_upstream",
                        lambda name, cfg, **kw: captured.setdefault("port " + name, cfg))
    for name in NEW_NAMES[3:13]:
        jax_registry.load(name)
        hub.load(name)
    from s3prl_tpu.models.wav2vec2 import BASE, LARGE

    assert captured["espnet_hubert"] is None  # JAX's default_cfg or BASE
    assert dataclasses.asdict(captured["port espnet_hubert"]) == dataclasses.asdict(BASE)
    assert (dataclasses.asdict(captured["port espnet_hubert_large"])
            == dataclasses.asdict(captured["espnet_hubert_large"]) == dataclasses.asdict(LARGE))
    monkeypatch.undo()
    for kw in ({"quantize": True}, {"full_fuse": True}):
        with pytest.raises(ValueError, match="cannot take effect on espnet_hubert"):
            hub.load("cvhubert", device="cpu", **kw)
    with pytest.raises(TypeError, match="unexpected"):
        hub.load("cvhubert", device="cpu", nonsense=1)


DISTILLER = dict(WIDTH, final_dim=128, n_tasks=3, dropout=0.0, attention_dropout=0.0,
                 activation_dropout=0.0)


@pytest.fixture(scope="module")
def distiller_params():
    model = jax_distiller.DistillerModel(jax_distiller.DistillerConfig(**DISTILLER))
    v = jax.jit(lambda k: model.init(k, jnp.zeros((1, 3200)), jnp.asarray([3200]),
                                     deterministic=True))(jax.random.key(0))
    rng = np.random.RandomState(5)
    return jax.tree_util.tree_map(
        lambda a: np.asarray(a) + 0.05 * rng.randn(*np.shape(a)).astype(np.float32),
        v["params"])


def jax_distiller_up(params, dtype=jnp.float32):
    model = jax_distiller.DistillerModel(jax_distiller.DistillerConfig(**DISTILLER), dtype=dtype)
    apply = jax.jit(lambda p, w, n: model.apply({"params": p}, w, n, deterministic=True))
    from s3prl_tpu.upstream.base import Upstream as JaxUpstream

    return JaxUpstream(name="tiny", params=params,
                       apply_fn=lambda p, w, n, train, rngs: apply(p, w, n), num_layers=6,
                       hidden_size=128, downsample_rate=320)


@pytest.mark.parametrize("precision", ["f32", "bf16"])
def test_distiller_matches_jax(distiller_params, precision):
    """The 1 + 2 + 3 states (projected features, layer outputs, head
    predictions) at f32 within 5e-4, bf16 per-layer cosine > 0.999."""
    jdtype, dtype = {"f32": (jnp.float32, torch.float32),
                     "bf16": (jnp.bfloat16, torch.bfloat16)}[precision]
    cfg = DistillerConfig(**DISTILLER)
    model = DistillerModel(cfg, dtype, device="meta")
    model.to_empty(device="cpu")
    model.load_state_dict(distiller_state_dict_from_jax(distiller_params, cfg))
    up = Upstream("tiny", model.eval(), 6, 128, 320)
    wavs, lens = _batch(72, LENS)
    jup = jax_distiller_up(distiller_params, jdtype)
    hs, h_lens = jup.apply_standardized(jup.params, jnp.asarray(wavs), jnp.asarray(lens))
    want, want_lens = np.asarray(jnp.asarray(hs, jnp.float32)), np.asarray(h_lens)
    got, got_lens = run_port(up, wavs, lens)
    assert got.shape == (6, 6, 30, 128)
    if precision == "f32":
        assert_f32_close(got, want, got_lens, want_lens)
    else:
        np.testing.assert_array_equal(got_lens, want_lens)
        coss = _layer_cosines(got, want, got_lens)
        assert min(coss) > 0.999, coss


def test_distiller_checkpoint_matches_jax(distiller_params, tmp_path):
    """A DistilHuBERT pretraining checkpoint ``{"Distiller", "Config"}``
    (the pos-conv under weight norm, the heads' bias [1, 1, n, D]) through
    both registries: the same config and f32 states within 5e-4; flash /
    quantize raise."""
    cfg = DistillerConfig(**DISTILLER)
    sd = distiller_state_dict_from_jax(distiller_params, cfg)
    weight_norm(sd, "encoder.pos_conv.0")
    dcfg = {"extractor_conv_feature_layers": str(list(CONV)), "encoder_layers": 2,
            "encoder_embed_dim": 128, "encoder_ffn_embed_dim": 256,
            "encoder_attention_heads": 2, "conv_pos": 16, "conv_pos_groups": 4,
            "final_dim": 128, "n_tasks": 3}
    path = tmp_path / "distiller.ckpt"
    torch.save({"Distiller": sd, "Config": {"distiller": dcfg}}, path)
    up = hub.load("distilhubert", ckpt=str(path), device="cpu")
    assert dataclasses.asdict(up.model.cfg) == dataclasses.asdict(
        DistillerConfig(**{**DISTILLER, "dropout": 0.1, "attention_dropout": 0.1,
                           "activation_dropout": 0.1}))
    jup = jax_hub.load("distiller", ckpt=str(path))
    wavs, lens = _batch(73, LENS)
    want, want_lens = run_jax_up(jup, wavs, lens)
    got, got_lens = run_port(up, wavs, lens)
    assert_f32_close(got, want, got_lens, want_lens)
    for kw in ({"flash": True}, {"quantize": True}):
        with pytest.raises(ValueError, match="cannot take effect on distilhubert"):
            hub.load("distilhubert", device="cpu", **kw)


@pytest.mark.parametrize("name", NEW_NAMES)
def test_new_entries_need_cuda_without_device(monkeypatch, name):
    """Each new name builds on the card unless device= says otherwise:
    without CUDA it raises and names device="cpu"."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match='device="cpu"'):
        hub.load(name, dtype=torch.bfloat16)


@pytest.mark.parametrize("site", ["dropout", "activation_dropout"])
def test_distiller_dropout_site_matches_jax(distiller_params, site):
    """Train mode with one rate at 1.0 (the other 0), which zeroes its site
    in both packages whatever their streams: the port's states are JAX's,
    and the site did something (they differ from eval mode's)."""
    fields = {**DISTILLER, site: 1.0}
    model = jax_distiller.DistillerModel(jax_distiller.DistillerConfig(**fields))
    run = jax.jit(lambda p, w, n: model.apply({"params": p}, w, n, deterministic=False,
                                              rngs={"dropout": jax.random.key(3)}))
    wavs, lens = _batch(74, LENS[:3])
    want, want_lens = run(distiller_params, jnp.asarray(wavs), jnp.asarray(lens))
    cfg = DistillerConfig(**fields)
    port = DistillerModel(cfg, device="meta")
    port.to_empty(device="cpu")
    port.load_state_dict(distiller_state_dict_from_jax(distiller_params, cfg))
    with torch.no_grad():
        got, got_lens = port.train()(torch.from_numpy(wavs), torch.from_numpy(lens),
                                     generator=torch.Generator().manual_seed(0))
        evaluated, _ = port.eval()(torch.from_numpy(wavs), torch.from_numpy(lens))
    np.testing.assert_array_equal(got_lens.numpy(), np.asarray(want_lens))
    for b, n in enumerate(np.asarray(want_lens)):
        np.testing.assert_allclose(got[:, b, :n].numpy(), np.asarray(want)[:, b, :n], atol=5e-4)
    assert not torch.allclose(got, evaluated, atol=1e-3)
