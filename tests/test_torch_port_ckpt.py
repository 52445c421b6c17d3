"""``ckpt=`` of s3prl_tpu_torch vs s3prl_tpu (CPU): checkpoints on disk.

Checkpoints are written into a temporary directory from seeded random
weights (a tiny JAX model's params, every leaf perturbed, in fairseq's
keys): s3prl's ``{"model_weight", "model_cfg", "task_cfg"}`` for a
wav2vec2-Large-style trunk with conv bias on the layer-norm extractor
(wav2vec2 lv60's, which turns K3 off), the pos-conv under weight norm
(``weight_g`` / ``weight_v``), the pretraining keys a fairseq checkpoint
carries (``final_proj``, ``label_embs_concat``, ``quantizer``,
``project_q``) and no ``mask_emb``; a bare data2vec state_dict with its
depth-5 pos-conv stack, read under the entry's configuration; Microsoft's
WavLM ``{"cfg", "model"}`` with and without the gate. Each is loaded by
the JAX registry (`load_trunk_variables` / `load_wavlm_checkpoint`) and by
the port's ``hub.load(entry, ckpt=path, device="cpu")``, and the hidden
states compared: f32 at atol 5e-4 over the valid frames (the ROADMAP
bar), int8 serving on the kernel route at per-layer cosine > 0.999. Both
registries' constants are patched to the tiny widths where a bare
state_dict takes the entry's configuration.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import s3prl_tpu.models.transformer as jax_transformer
import s3prl_tpu.upstream.registry as jax_registry
import s3prl_tpu_torch.models.transformer as port_transformer
import s3prl_tpu_torch.upstream.registry as port_registry
from s3prl_tpu.models.wav2vec2 import Wav2Vec2Trunk as JaxTrunk
from s3prl_tpu.models.wavlm import WavLMModel as JaxWavLM
from s3prl_tpu_torch import hub
from s3prl_tpu_torch.upstream.convert import (trunk_state_dict_from_jax,
                                              wavlm_state_dict_from_jax)
from test_torch_port_slice import _batch, _jax_defaults, _layer_cosines  # noqa: F401 (fixture)
from test_torch_port_w2v2 import (CASES, CONV, LENS, WIDTH, assert_f32_close, configs,
                                  framed, jax_init, run_port)

# fairseq's model_cfg of the tiny wav2vec2-Large-style trunk (lv60: conv bias)
W2V2_CFG = {"_name": "wav2vec2", "extractor_mode": "layer_norm",
            "conv_feature_layers": str(list(CONV)), "encoder_layers": 2,
            "encoder_embed_dim": 128, "encoder_ffn_embed_dim": 256,
            "encoder_attention_heads": 2, "layer_norm_first": True, "conv_bias": True,
            "conv_pos": 16, "conv_pos_groups": 4, "dropout": 0.0, "attention_dropout": 0.0,
            "dropout_input": 0.0}
WAVLM_CFG = {"extractor_mode": "default", "conv_feature_layers": str(list(CONV)),
             "encoder_layers": 2, "encoder_embed_dim": 128, "encoder_ffn_embed_dim": 256,
             "encoder_attention_heads": 2, "conv_pos": 16, "conv_pos_groups": 4,
             "layer_norm_first": False, "normalize": False}
EXTRA = {  # keys a fairseq pretraining checkpoint carries beyond the trunk
    "final_proj.weight": torch.randn(16, 128), "final_proj.bias": torch.zeros(16),
    "label_embs_concat": torch.randn(32, 16), "quantizer.vars": torch.randn(1, 8, 16),
    "quantizer.weight_proj.weight": torch.randn(8, 64), "project_q.weight": torch.randn(16, 16),
}


def weight_norm(sd):
    """The one pos-conv as fairseq stores it: weight_g ||v|| over dims (0, 1), weight_v."""
    w = sd.pop("encoder.pos_conv.0.weight")
    sd["encoder.pos_conv.0.weight_g"] = w.norm(dim=(0, 1), keepdim=True)
    sd["encoder.pos_conv.0.weight_v"] = w
    return sd


def jax_run(up, wavs, lens):
    """The JAX upstream's `apply_standardized`, its apply_fn jitted."""
    apply = jax.jit(up.apply_fn)
    jitted = dataclasses.replace(up, apply_fn=lambda v, w, n, train=False, rngs=None:
                                 apply(v, w, n))
    hs, h_lens = jitted.apply_standardized(up.params, jnp.asarray(wavs), jnp.asarray(lens))
    return np.asarray(jnp.asarray(hs, jnp.float32)), np.asarray(h_lens)


def kernels_on(monkeypatch):
    monkeypatch.setattr(jax_transformer, "_fused_block_available", lambda: True)
    monkeypatch.setattr(port_transformer, "_fused_block_available", lambda x: True)


INT8 = dict(dtype=jnp.bfloat16, flash=True, quantize=True)


def int8_cos(monkeypatch, entry, path, wavs, lens):
    """Per-layer cosines of the port's int8 model from `path` against the
    JAX registry's, both on the kernel route, over the valid frames; under
    the conv rule not those of an utterance with no frame, where JAX's
    padded cells weigh their padding (tests/test_torch_port_w2v2.py)."""
    kernels_on(monkeypatch)
    want, _ = jax_run(jax_registry.load(entry, ckpt=str(path), **INT8), wavs, lens)
    up = hub.load(entry, ckpt=str(path), device="cpu", **{**INT8, "dtype": torch.bfloat16})
    got, h_lens = run_port(up, wavs, lens)
    if up.model.cfg.feat_pad_rule == "conv":
        h_lens = framed(lens, h_lens, up.model.cfg.conv_feature_layers)
    return _layer_cosines(got, want, h_lens)


@pytest.fixture(scope="module")
def w2v2_ckpt(tmp_path_factory):
    """An s3prl-style wav2vec2-Large checkpoint (conv bias, weight norm,
    fairseq's extra keys, no mask_emb)."""
    kw = {**WIDTH, **CASES["w2v2-large"], "conv_bias": True}
    from s3prl_tpu.models.wav2vec2 import Wav2Vec2Config as JaxConfig
    from s3prl_tpu_torch.models.wav2vec2 import Wav2Vec2Config
    sd = trunk_state_dict_from_jax(jax_init(JaxTrunk(JaxConfig(**kw))), Wav2Vec2Config(**kw))
    assert "feature_extractor.conv_layers.0.0.bias" in sd
    del sd["mask_emb"]
    path = tmp_path_factory.mktemp("ckpt") / "wav2vec2_lv60.pt"
    torch.save({"model_weight": {**weight_norm(sd), **EXTRA}, "model_cfg": W2V2_CFG,
                "task_cfg": {"normalize": True}}, path)
    return path


def test_s3prl_trunk_checkpoint_matches_jax(w2v2_ckpt, monkeypatch):
    """The configuration comes from the checkpoint's model_cfg (the conv
    rule for ``_name`` wav2vec2, normalize from task_cfg, conv bias), the
    pos-conv folded from weight norm, the mask embedding zeros, the extra
    keys left out; f32 atol 5e-4, int8 (K3 off: conv bias) cosine > 0.999."""
    wavs, lens = _batch(60, LENS)
    jup = jax_registry.load("wav2vec2_large_ll60k", ckpt=str(w2v2_ckpt))
    up = hub.load("wav2vec2_large_ll60k", ckpt=str(w2v2_ckpt), device="cpu")
    cfg = up.model.cfg
    assert (cfg.feat_pad_rule, cfg.normalize, cfg.conv_bias, cfg.encoder_layers) == (
        "conv", True, True, 2)
    assert torch.equal(up.model.mask_emb, torch.zeros(128))
    assert not up.model.feature_extractor.fuse0  # K3 needs a bias-free conv0
    want, want_lens = jax_run(jup, wavs, lens)
    got, got_lens = run_port(up, wavs, lens)
    assert_f32_close(got, want, got_lens, want_lens)
    coss = int8_cos(monkeypatch, "wav2vec2_large_ll60k", w2v2_ckpt, wavs, lens)
    assert min(coss) > 0.999, coss


def test_int8_codes_come_from_the_checkpoints_f32_weights(w2v2_ckpt):
    """The int8 model keeps the checkpoint's f32 weights and quantizes its
    cache from them on the CPU, once (ROADMAP "int8 weights from f32")."""
    f32 = hub.load("wav2vec2_large_ll60k", ckpt=str(w2v2_ckpt), device="cpu")
    q8 = hub.load("wav2vec2_large_ll60k", ckpt=str(w2v2_ckpt), device="cpu",
                  dtype=torch.bfloat16, flash=True, quantize=True)
    a, b = f32.model.encoder.layers[1], q8.model.encoder.layers[1]
    assert b.fc1.weight.dtype == torch.float32 and torch.equal(a.fc1.weight, b.fc1.weight)
    rebuilt = type(b)(128, 256, 2, torch.bfloat16, True, True, device="cpu",
                      layer_norm_first=True)
    rebuilt.load_state_dict(b.state_dict())
    for name in ("fc1", "fc2"):
        assert torch.equal(b.qpair(name)[0], rebuilt.qpair(name)[0])
        assert torch.equal(b.qpair(name)[1], rebuilt.qpair(name)[1])


def patch_tiny(monkeypatch, const, **fields):
    """Both registries' `const` at the tiny widths (the family's fields kept)."""
    cfgs = []
    for module in (port_registry, jax_registry):
        cfg = dataclasses.replace(getattr(module, const), **{**WIDTH, **fields})
        monkeypatch.setattr(module, const, cfg)
        cfgs.append(cfg)
    return cfgs[0]


def test_bare_data2vec_state_dict_takes_the_entry_config(tmp_path, monkeypatch):
    """A bare state_dict with the depth-5 stack (encoder.pos_conv.{i}.0.*)
    under the data2vec entry's configuration: f32 atol 5e-4, int8 cosine >
    0.999. The same file under an s3prl model_cfg (``_name``
    data2vec_audio), from which the JAX loader takes no pos_conv_depth,
    raises naming both depths."""
    data2vec = CASES["data2vec"]
    cfg = patch_tiny(monkeypatch, "DATA2VEC_BASE", conv_pos=data2vec["conv_pos"],
                     conv_feature_layers=data2vec["conv_feature_layers"])
    jcfg, pcfg = configs("data2vec")
    assert dataclasses.asdict(cfg) == dataclasses.asdict(pcfg)
    sd = trunk_state_dict_from_jax(jax_init(JaxTrunk(jcfg)), pcfg)
    assert "encoder.pos_conv.4.0.weight" in sd
    path = tmp_path / "data2vec.pt"
    torch.save({**sd, **EXTRA}, path)
    wavs, lens = _batch(61, LENS)
    want, want_lens = jax_run(jax_registry.load("data2vec", ckpt=str(path)), wavs, lens)
    got, got_lens = run_port(hub.load("data2vec", ckpt=str(path), device="cpu"), wavs, lens)
    assert_f32_close(got, want, got_lens, want_lens)
    coss = int8_cos(monkeypatch, "data2vec", path, wavs, lens)
    assert min(coss) > 0.999, coss
    s3prl = tmp_path / "data2vec_s3prl.pt"
    model_cfg = {**W2V2_CFG, "_name": "data2vec_audio", "layer_norm_first": False,
                 "conv_bias": False, "conv_pos": data2vec["conv_pos"]}
    torch.save({"model_weight": sd, "model_cfg": model_cfg}, s3prl)
    with pytest.raises(ValueError, match="depth-5 pos-conv stack.*depth-1"):
        hub.load("data2vec", ckpt=str(s3prl), device="cpu")


@pytest.mark.parametrize("case,entry", [("gated", "wavlm"), ("gated", "unispeech_sat"),
                                        ("no-gate", "wavlm_base_plus")])
def test_microsoft_wavlm_checkpoint_matches_jax(tmp_path, monkeypatch, case, entry):
    """Microsoft's ``{"cfg", "model"}`` (weight norm; the gate and the bias
    table where the cfg has them) through the WavLM and UniSpeech-SAT
    entries: the configuration from the checkpoint, f32 atol 5e-4, int8
    cosine > 0.999."""
    extra = {} if case == "gated" else {"gru_rel_pos": False}
    jcfg, pcfg = (configs("no-gate") if extra else
                  tuple(dataclasses.replace(c, gru_rel_pos=True) for c in configs("no-gate")))
    sd = wavlm_state_dict_from_jax(jax_init(JaxWavLM(jcfg)), pcfg)
    assert any("grep_a" in key for key in sd) == (case == "gated")
    path = tmp_path / "wavlm.pt"
    torch.save({"cfg": {**WAVLM_CFG, **extra}, "model": weight_norm(sd)}, path)
    wavs, lens = _batch(62, LENS)
    want, want_lens = jax_run(jax_registry.load(entry, ckpt=str(path)), wavs, lens)
    up = hub.load(entry, ckpt=str(path), device="cpu")
    assert up.model.cfg.gru_rel_pos == (case == "gated")
    assert not hasattr(up, "apply_weighted")
    got, got_lens = run_port(up, wavs, lens)
    assert_f32_close(got, want, got_lens, want_lens)
    coss = int8_cos(monkeypatch, entry, path, wavs, lens)
    assert min(coss) > 0.999, coss


def test_checkpoint_round_trip_is_exact(tmp_path, monkeypatch):
    """A seeded model's state_dict saved as a bare checkpoint loads through
    ckpt= to the same weights, the same int8 cache and the same hidden
    states, bit for bit."""
    monkeypatch.setattr(port_registry, "HUBERT_BASE",
                        dataclasses.replace(port_registry.HUBERT_BASE, **WIDTH))
    for quantize in (False, True):
        kw = dict(dtype=torch.bfloat16, flash=True, quantize=True) if quantize else {}
        seeded = hub.load("hubert", device="cpu", seed=7, **kw)
        path = tmp_path / f"hubert_{quantize}.pt"
        torch.save(seeded.model.state_dict(), path)
        loaded = hub.load("hubert", ckpt=str(path), device="cpu", **kw)
        a, b = seeded.model.state_dict(keep_vars=False), loaded.model.state_dict()
        assert a.keys() == b.keys() and all(torch.equal(a[k], b[k]) for k in a)
        layer_a, layer_b = seeded.model.encoder.layers[0], loaded.model.encoder.layers[0]
        if quantize:
            assert torch.equal(layer_a.qpair("fc1")[0], layer_b.qpair("fc1")[0])
        wavs, lens = (torch.from_numpy(x) for x in _batch(63, LENS))
        assert torch.equal(seeded.apply_standardized(wavs, lens)[0],
                           loaded.apply_standardized(wavs, lens)[0])


@pytest.fixture
def no_cuda(monkeypatch):
    """Any step that reaches CUDA, or materialises a model, fails the test."""
    monkeypatch.setattr(torch.cuda, "_lazy_init", lambda: pytest.fail("CUDA was touched"))
    monkeypatch.setattr(torch.nn.Module, "to_empty",
                        lambda *a, **k: pytest.fail("a model was allocated"))


def test_card_refusal_from_a_checkpoint_comes_first(tmp_path, no_cuda, monkeypatch):
    """XLS-R 1B's shape from its checkpoint (C 1,280 in 16 heads: head dim
    80) with ``flash=True`` for the card raises at load, naming the limit,
    before a model is allocated or CUDA is touched; the same file builds on
    the CPU, where the plain attention takes any head dim."""
    cfg = {**W2V2_CFG, "encoder_layers": 1, "encoder_embed_dim": 1280,
           "encoder_attention_heads": 16, "conv_bias": False}
    from s3prl_tpu_torch.models.wav2vec2 import Wav2Vec2Config, Wav2Vec2Trunk
    pcfg = Wav2Vec2Config(**{**WIDTH, **CASES["w2v2-large"], "encoder_layers": 1,
                             "encoder_embed_dim": 1280, "encoder_attention_heads": 16})
    model = Wav2Vec2Trunk(pcfg, device="meta")
    sd = {k: torch.zeros(v.shape) for k, v in model.state_dict().items()}
    path = tmp_path / "xls_r_1b.pt"
    torch.save({"model_weight": sd, "model_cfg": cfg, "task_cfg": {"normalize": True}}, path)
    with pytest.raises(ValueError, match="head dim 64, got 1280 channels in 16 heads"):
        hub.load("xls_r_1b", ckpt=str(path), dtype=torch.bfloat16, flash=True, quantize=True,
                 device="cuda")
    monkeypatch.undo()
    up = hub.load("xls_r_1b", ckpt=str(path), dtype=torch.bfloat16, flash=True, device="cpu")
    assert up.hidden_size == 1280 and up.model.encoder.layers[0].num_heads == 16


@pytest.mark.parametrize("entry", ["wav2vec2", "data2vec_large_ll60k", "unispeech_sat"])
def test_nothing_is_downloaded(no_cuda, entry):
    """download=True raises before a model is made: the port fetches nothing."""
    with pytest.raises(NotImplementedError, match="pass ckpt= with a local checkpoint"):
        hub.load(entry, download=True, device="cpu")
