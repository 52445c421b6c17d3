"""The ``hf_*`` entries on the port's wav2vec2 trunk, and trunks whose FFN
activation is ReLU or swish, in s3prl_tpu_torch vs s3prl_tpu (CPU).

HF: a tiny transformers ``FlaxWav2Vec2Model`` (two stable-layer-norm
layers at 64 wide, a three-layer layer-norm extractor at stride 20, a
16-tap pos-conv in 4 groups), every parameter moved by 0.05 N(0, 1), is
saved with ``save_pretrained``; transformers converts it to its torch
model, which writes ``pytorch_model.bin`` and ``model.safetensors``. The
JAX hub loads the Flax directory (transformers' Flax code), the port the
torch ones (`convert_hf`, which imports no transformers). The batch holds
a 12-sample row, which under HF's mask arithmetic attends to all frames
but one (`hf_frames`). States at atol 5e-4 in f32; lengths equal.

ReLU / swish: the tiny trunks of `test_torch_port_train_mode` (two layers
of C 128 on a three-layer conv stack, pre-LN HuBERT-style and post-LN
wav2vec2-Base-style), JAX params perturbed and carried across: f32 at
5e-4; int8 (``quantize=True, flash=True``, the fused routes made
available in both packages) at per-layer cosine 0.999, with spies showing
that neither package launches a fused block or FFN kernel, only the
attention between the projections (K7); and through an s3prl checkpoint
whose ``model_cfg`` says ``activation_fn``; MR-HuBERT's encoders take
them too.
"""

import copy
import json

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

import s3prl_tpu.kernels.ffn as jax_ffn
import s3prl_tpu.kernels.flash_attention as jax_fa
import s3prl_tpu.models.transformer as jax_transformer
import s3prl_tpu_torch.models.convfe as port_convfe
import s3prl_tpu_torch.models.transformer as port_transformer
from s3prl_tpu import hub as jax_hub
from s3prl_tpu.upstream.base import standardize_hidden_states
from s3prl_tpu_torch import hub
from s3prl_tpu_torch.models.wavlm import WavLMConfig, WavLMModel
from s3prl_tpu_torch.upstream.convert_hf import (HF_DEFAULT_ENTRY, hf_config, load_hf_directory,
                                                 read_safetensors)
from test_torch_port_patch_transformers import perturbed, run_both, waves
from test_torch_port_train_mode import (jax_trunk_states, layer_cosines, port_states, port_trunk,
                                        trunk_configs)
from test_torch_port_train_mode import assert_close as assert_trunk_close
from test_torch_port_train_mode import waves as trunk_waves

HF_TINY = dict(hidden_size=64, num_hidden_layers=2, num_attention_heads=2, intermediate_size=128,
               conv_dim=(32, 32, 32), conv_kernel=(10, 3, 3), conv_stride=(5, 2, 2),
               num_conv_pos_embeddings=16, num_conv_pos_embedding_groups=4,
               do_stable_layer_norm=True, feat_extract_norm="layer")
HF_LENS = np.asarray([4000, 2001, 12], np.int32)


@pytest.fixture(scope="module")
def hf_dirs(tmp_path_factory):
    """{"flax", "bin", "safe"}: one perturbed tiny model in the three forms."""
    from transformers import FlaxWav2Vec2Model, Wav2Vec2Config, Wav2Vec2Model
    from transformers.modeling_flax_pytorch_utils import load_flax_weights_in_pytorch_model

    root = tmp_path_factory.mktemp("hf")
    config = Wav2Vec2Config(**HF_TINY)
    model = FlaxWav2Vec2Model(config, seed=0)
    model.params = perturbed(model.params)
    model.save_pretrained(root / "flax")
    pt = load_flax_weights_in_pytorch_model(Wav2Vec2Model(config), model.params)
    pt.save_pretrained(root / "bin", safe_serialization=False)
    pt.save_pretrained(root / "safe", safe_serialization=True)
    return {form: str(root / form) for form in ("flax", "bin", "safe")}


_JAX_HF = {}


def jax_hf(hf_dirs, name="hf_wav2vec2"):
    if name not in _JAX_HF:
        _JAX_HF[name] = jax_hub.load(name, ckpt=hf_dirs["flax"])
    return copy.copy(_JAX_HF[name])


@pytest.mark.parametrize("form", ["bin", "safe"])
def test_hf_directory_matches_jax(hf_dirs, form):
    """transformers' Flax model (JAX hub) against the port's trunk from the
    torch directory: every state at 5e-4, the lengths (HF's mask frames
    inside, the JAX entry's ceil(len / r) out), the metadata."""
    jup = jax_hf(hf_dirs)
    up = hub.load("hf_wav2vec2", ckpt=hf_dirs[form], device="cpu")
    got, want = run_both(jup, up, waves(HF_LENS), HF_LENS)
    assert got.shape[0] == 3
    np.testing.assert_allclose(got, want, atol=5e-4, rtol=0)
    assert (up.num_layers, up.hidden_size, up.downsample_rate) == (
        jup.num_layers, jup.hidden_size, jup.downsample_rate)


def test_hf_hubert_rides_the_same_model(hf_dirs):
    """hf_hubert (and the _custom names) build the same model from the same
    directory, as the JAX entry rides FlaxWav2Vec2Model."""
    x, lens = torch.from_numpy(waves(HF_LENS)), torch.from_numpy(HF_LENS)
    ref, _ = hub.load("hf_wav2vec2", ckpt=hf_dirs["bin"], device="cpu")(x, lens)
    for name in ("hf_hubert", "hf_hubert_custom", "hf_wav2vec2_custom"):
        got, _ = hub.load(name, ckpt=hf_dirs["bin"], device="cpu")(x, lens)
        assert torch.equal(got, ref), name
    jup = jax_hf(hf_dirs, "hf_hubert")
    got, want = run_both(jup, hub.load("hf_hubert", ckpt=hf_dirs["bin"], device="cpu"),
                         waves(HF_LENS), HF_LENS)
    np.testing.assert_allclose(got, want, atol=5e-4, rtol=0)


def test_hf_train_mode_runs_the_eval_computation(hf_dirs, monkeypatch):
    """Train mode computes eval mode's states (the JAX entry passes
    train=False), its modules stay in eval mode, and the extractor's first
    layer goes through the K3 wrapper once a forward in both."""
    calls = []
    k3 = port_convfe.conv0_ln_gelu
    monkeypatch.setattr(port_convfe, "conv0_ln_gelu",
                        lambda *a, **k: calls.append(1) or k3(*a, **k))
    up = hub.load("hf_wav2vec2", ckpt=hf_dirs["bin"], device="cpu")
    x, lens = torch.from_numpy(waves(HF_LENS)), torch.from_numpy(HF_LENS)
    ref, _ = up(x, lens)
    got, _ = up(x, lens, train=True, generator=torch.Generator().manual_seed(0))
    assert up.model.training and not any(m.training for m in up.model.modules()
                                         if m is not up.model)
    assert torch.equal(got, ref) and len(calls) == 2


def test_safetensors_reader(hf_dirs, tmp_path):
    """The reader by the documented layout: transformers' file equals its
    pytorch_model.bin; a file of bf16, f16 and int64 tensors (written by
    the safetensors package) reads back bit for bit."""
    from safetensors.torch import save_file

    safe = read_safetensors(f"{hf_dirs['safe']}/model.safetensors")
    ref = torch.load(f"{hf_dirs['bin']}/pytorch_model.bin", weights_only=True)
    assert set(safe) == set(ref)
    assert all(torch.equal(safe[k], ref[k]) for k in ref)
    tensors = {"a": torch.randn(3, 5).bfloat16(), "b": torch.randn(7).half(),
               "c": torch.arange(6).reshape(2, 3), "d": torch.zeros(0)}
    save_file(tensors, str(tmp_path / "x.safetensors"))
    back = read_safetensors(tmp_path / "x.safetensors")
    assert all(torch.equal(back[k], v) and back[k].dtype == v.dtype for k, v in tensors.items())


def test_hf_default_entry_config():
    """Without ckpt: transformers' Wav2Vec2Config(do_stable_layer_norm=True,
    feat_extract_norm="layer") field for field: 12 x 768, 12 heads, FFN
    3,072, no conv bias, a pos-conv of 16 groups of 48, 13 states, stride
    320."""
    from transformers import Wav2Vec2Config

    hf = Wav2Vec2Config(do_stable_layer_norm=True, feat_extract_norm="layer")
    cfg = hf_config(HF_DEFAULT_ENTRY)
    assert cfg == hf_config(hf.to_dict())
    assert (cfg.encoder_layers, cfg.encoder_embed_dim, cfg.encoder_attention_heads,
            cfg.encoder_ffn_embed_dim, cfg.conv_bias, cfg.conv_pos, cfg.conv_pos_groups) == (
        hf.num_hidden_layers, hf.hidden_size, hf.num_attention_heads, hf.intermediate_size,
        hf.conv_bias, hf.num_conv_pos_embeddings, hf.num_conv_pos_embedding_groups)
    assert cfg.layer_norm_first and cfg.extractor_mode == "layer_norm"
    up = hub.load("hf_wav2vec2", device="cpu")
    assert (up.num_layers, up.hidden_size, up.downsample_rate) == (13, 768, 320)


def test_hf_refusals(tmp_path, monkeypatch):
    """The trunk keywords and a dtype other than f32 raise; a model id or a
    URL raises NotImplementedError (Queue 1 item 11); a directory of a
    post-LN model, or without torch weights, raises; without CUDA and
    without device= the entries raise."""
    with pytest.raises(ValueError, match="flash cannot take effect on hf_wav2vec2"):
        hub.load("hf_wav2vec2", flash=True, device="cpu")
    with pytest.raises(ValueError, match="quantize cannot take effect on hf_hubert"):
        hub.load("hf_hubert", quantize=True, device="cpu")
    with pytest.raises(ValueError, match="dtype"):
        hub.load("hf_wav2vec2", dtype=torch.bfloat16, device="cpu")
    for ckpt in ("facebook/wav2vec2-large-lv60", "https://example.invalid/model"):
        with pytest.raises(NotImplementedError, match="Queue 1 item 11"):
            hub.load("hf_wav2vec2_custom", ckpt=ckpt, device="cpu")
    (tmp_path / "config.json").write_text(json.dumps({"do_stable_layer_norm": False}))
    with pytest.raises(NotImplementedError, match="stable-layer-norm"):
        load_hf_directory(tmp_path)
    (tmp_path / "config.json").write_text(json.dumps(HF_TINY))
    with pytest.raises(FileNotFoundError):
        load_hf_directory(tmp_path)
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    for name in ("hf_wav2vec2", "hf_hubert"):
        with pytest.raises(RuntimeError, match='device="cpu"'):
            hub.load(name)


# -- ReLU and swish trunks ------------------------------------------------------------------

FAMILIES = ["hubert-pre-ln", "w2v2-base-post-ln"]


@pytest.fixture(scope="module")
def params():
    """Each family's perturbed JAX params (the activation adds none)."""
    out = {}
    for family in FAMILIES:
        jcfg, _, jcls, _ = trunk_configs(family)
        init = jax.jit(lambda k, w, n: jcls(jcfg).init(k, w, n, deterministic=True))
        out[family] = perturbed(init(jax.random.key(0), jnp.zeros((1, 3200)),
                                     jnp.asarray([3200]))["params"])
    return out


def spies(monkeypatch, module, names):
    calls = {}
    for name in names:
        fn = getattr(module, name)
        calls[name] = []
        monkeypatch.setattr(module, name, lambda *a, _fn=fn, _c=calls[name], **k:
                            _c.append(1) or _fn(*a, **k))
    return calls


PORT_FUSED = ("fused_attention_block", "fused_attention_block_bf16", "fused_int8_ffn",
              "fused_bf16_ffn", "fused_int8_linear", "fused_qkv_attention_outproj")


@pytest.mark.parametrize("activation", ["relu", "swish"])
@pytest.mark.parametrize("family", FAMILIES)
def test_relu_swish_trunk_f32_matches_jax(params, family, activation):
    """f32: every state at 5e-4; the activation changes them (it is read)."""
    wavs, lens = trunk_waves()
    want, want_lens = jax_trunk_states(family, params[family], wavs, lens, False,
                                       activation_fn=activation)
    got, got_lens = port_states(port_trunk(family, params[family], activation_fn=activation),
                                wavs, lens, False)
    assert_trunk_close(got, want, got_lens, want_lens)
    gelu, _ = port_states(port_trunk(family, params[family]), wavs, lens, False)
    assert not np.allclose(got[-1], gelu[-1], atol=1e-2)


@pytest.mark.parametrize("activation", ["relu", "swish"])
@pytest.mark.parametrize("family", FAMILIES)
def test_relu_swish_trunk_int8_takes_no_fused_kernel(params, monkeypatch, family, activation):
    """int8 serving with the fused routes available in both packages: no
    whole-block or FFN kernel in either (the gelu gate), the attention K7
    once a layer in both; per-layer cosine > 0.999."""
    monkeypatch.setattr(jax_transformer, "_fused_block_available", lambda: True)
    monkeypatch.setattr(port_transformer, "_fused_block_available", lambda x: True)
    port_calls = spies(monkeypatch, port_transformer, PORT_FUSED + ("fused_qkv_attention",))
    jax_calls = {**spies(monkeypatch, jax_ffn, ("fused_int8_ffn", "fused_int8_linear")),
                 **spies(monkeypatch, jax_fa, ("fused_attention_block",
                                               "fused_qkv_attention_outproj",
                                               "fused_qkv_attention"))}
    wavs, lens = trunk_waves(seed=1)
    want, want_lens = jax_trunk_states(family, params[family], wavs, lens, False,
                                       dtype=jnp.bfloat16, flash=True, quantize=True,
                                       activation_fn=activation)
    up = port_trunk(family, params[family], torch.bfloat16, flash=True, quantize=True,
                    activation_fn=activation)
    got, got_lens = port_states(up, wavs, lens, False)
    np.testing.assert_array_equal(got_lens, want_lens)
    assert not any(port_calls[name] for name in PORT_FUSED), port_calls
    assert len(port_calls["fused_qkv_attention"]) == 2
    assert jax_calls.pop("fused_qkv_attention") and not any(jax_calls.values()), jax_calls
    assert min(layer_cosines(got, want, got_lens)) > 0.999


@pytest.mark.parametrize("family", FAMILIES)
def test_gelu_trunk_still_takes_the_fused_kernels(params, monkeypatch, family):
    """The control: the same int8 trunk with gelu launches K1 and K2 a
    layer, as before."""
    monkeypatch.setattr(port_transformer, "_fused_block_available", lambda x: True)
    calls = spies(monkeypatch, port_transformer, ("fused_attention_block", "fused_int8_ffn"))
    up = port_trunk(family, params[family], torch.bfloat16, flash=True, quantize=True)
    port_states(up, *trunk_waves(seed=1), False)
    assert len(calls["fused_attention_block"]) == len(calls["fused_int8_ffn"]) == 2


def test_swish_bf16_routes():
    """bf16 with flash: a pre-LN swish layer keeps K4 (whose gate in the JAX
    package reads no activation) and drops K5; a post-LN one takes neither."""
    from s3prl_tpu_torch.models.transformer import EncoderLayer

    x = torch.randn(2, 9, 128).bfloat16()
    kv, pad = torch.full((2,), 9, dtype=torch.int32), torch.zeros(2, 9, dtype=torch.bool)
    for first, want in ((True, ["fused_attention_block_bf16"]), (False, [])):
        layer = EncoderLayer(128, 256, 2, torch.bfloat16, use_flash=True, layer_norm_first=first,
                             activation="swish").eval()
        calls = []
        with pytest.MonkeyPatch.context() as mp:
            mp.setattr(port_transformer, "_fused_block_available", lambda x: True)
            for name in ("fused_attention_block_bf16", "fused_bf16_ffn"):
                fn = getattr(port_transformer, name)
                mp.setattr(port_transformer, name, lambda *a, _n=name, _f=fn, **k:
                           calls.append(_n) or _f(*a, **k))
            with torch.no_grad():
                layer(x, kv, pad)
        assert calls == want


def test_swish_checkpoint_through_both_hubs(params, tmp_path):
    """An s3prl checkpoint whose model_cfg says activation_fn swish: both
    hubs read it (the JAX converters' config maps) and give the same f32
    states; the activation is in the port's config."""
    family = "hubert-pre-ln"
    up = port_trunk(family, params[family], activation_fn="swish")
    conv = str([list(c) for c in up.model.cfg.conv_feature_layers])
    model_cfg = {"_name": "hubert", "extractor_mode": "layer_norm", "encoder_layers": 2,
                 "encoder_embed_dim": 128, "encoder_ffn_embed_dim": 256,
                 "encoder_attention_heads": 4, "activation_fn": "swish",
                 "layer_norm_first": True, "conv_pos": 16, "conv_pos_groups": 4,
                 "conv_feature_layers": conv, "dropout": 0.0, "attention_dropout": 0.0,
                 "dropout_input": 0.0}
    path = str(tmp_path / "swish.ckpt")
    torch.save({"model_weight": up.model.state_dict(), "model_cfg": model_cfg,
                "task_cfg": {"normalize": True}}, path)
    jup = jax_hub.load("hubert", ckpt=path)
    port = hub.load("hubert", ckpt=path, device="cpu")
    assert port.model.cfg.activation_fn == "swish"
    wavs, lens = trunk_waves(seed=2)
    want, want_lens = jax.jit(jup.__call__)(jnp.asarray(wavs), jnp.asarray(lens))
    got, got_lens = port(torch.from_numpy(wavs), torch.from_numpy(lens))
    assert_trunk_close(got.numpy(), np.asarray(want), got_lens.numpy(), np.asarray(want_lens))


@pytest.mark.parametrize("activation", ["relu", "swish"])
def test_multires_hubert_activation_matches_jax(activation):
    """MR-HuBERT (`test_torch_port_lighthubert_mr`'s adapter case) with
    activation_fn relu / swish: every state at 5e-4 in f32."""
    import s3prl_tpu.models.multires_hubert as jax_multires
    from s3prl_tpu_torch.models.multires_hubert import MultiresHubertConfig, MultiresHubertModel
    from s3prl_tpu_torch.upstream.base import Upstream
    from s3prl_tpu_torch.upstream.convert import multires_hubert_state_dict_from_jax
    from test_torch_port_lighthubert_mr import MR, jax_init
    from test_torch_port_w2v2 import assert_f32_close, run_port

    fields = dict(MR["adapter"], activation_fn=activation)
    jmodel = jax_multires.MultiresHubertModel(jax_multires.MultiresHubertConfig(**fields))
    params = jax_init(jmodel, 1)
    cfg = MultiresHubertConfig(**fields)
    model = MultiresHubertModel(cfg, device="meta")
    model.to_empty(device="cpu")
    model.load_state_dict(multires_hubert_state_dict_from_jax(params, cfg))
    up = Upstream("mr", model.eval(), cfg.num_hidden_states, 128, 320)
    wavs, lens = trunk_waves(seed=3)
    hs, h_lens = jax.jit(lambda p, w, n: jmodel.apply({"params": p}, w, n, deterministic=True))(
        params, jnp.asarray(wavs), jnp.asarray(lens))
    got, got_lens = run_port(up, wavs, lens)
    want, want_lens = standardize_hidden_states(hs, jnp.asarray(lens), wavs.shape[1], 320)
    assert_f32_close(got, np.asarray(want), got_lens, np.asarray(want_lens))


def test_wavlm_keeps_refusing_other_activations():
    """The JAX WavLM layer's FFN runs GELU whatever activation_fn says, so
    the port's WavLM refuses relu / swish."""
    with pytest.raises(NotImplementedError, match="activation_fn 'swish'"):
        WavLMModel(WavLMConfig(activation_fn="swish"), device="meta")
