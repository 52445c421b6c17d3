"""The wav2vec2-family trunks' train mode in s3prl_tpu_torch vs s3prl_tpu
(CPU): every dropout site of HuBERT pre-LN, wav2vec2-Base post-LN and
WavLM (pre- and post-LN), train mode at rates 0, the attention kernels'
route inside train mode (K7 / K9) and layerdrop's refusal
(`test_torch_port_train_mode_mel` holds the other families and the
Trainer).

Each family runs at a tiny width (two layers of C 128 on a three-layer
conv stack) on JAX params with every leaf perturbed, carried to the port by its
converters. Both packages draw their masks from streams of their own, so
the site comparisons set one rate to 1.0 and the others to 0: flax's and
the port's p = 1 both give zeros, and the result is deterministic. f32
states at atol 5e-4 (the ROADMAP bar); bf16 / int8 per-layer cosine >
0.999 over the valid frames.
"""

import dataclasses

import numpy as np
import pytest
import torch

import flax
import jax
import jax.numpy as jnp

import s3prl_tpu.kernels.flash_attention as jax_fa
import s3prl_tpu_torch.models.transformer as port_transformer
from s3prl_tpu.models.wav2vec2 import Wav2Vec2Config as JaxConfig
from s3prl_tpu.models.wav2vec2 import Wav2Vec2Trunk as JaxTrunk
from s3prl_tpu.models.wavlm import WavLMConfig as JaxWavLMConfig
from s3prl_tpu.models.wavlm import WavLMModel as JaxWavLM
from s3prl_tpu.upstream.base import Upstream as JaxUpstream
from s3prl_tpu_torch.models.wav2vec2 import Wav2Vec2Config, Wav2Vec2Trunk
from s3prl_tpu_torch.models.wavlm import WavLMConfig, WavLMModel
from s3prl_tpu_torch.upstream.base import Upstream
from s3prl_tpu_torch.upstream.convert import trunk_state_dict_from_jax, wavlm_state_dict_from_jax
from test_torch_port_w2v2 import perturbed

CONV = ((64, 10, 5), (64, 3, 2), (64, 2, 2))
STRIDE = 20
RATES0 = dict(dropout=0.0, attention_dropout=0.0, activation_dropout=0.0, dropout_input=0.0)
WIDTH = dict(conv_feature_layers=CONV, encoder_layers=2, encoder_embed_dim=128,
             encoder_ffn_embed_dim=256, encoder_attention_heads=4, conv_pos=16,
             conv_pos_groups=4, **RATES0)
TRUNKS = {  # family -> (its fields, WavLM)
    "hubert-pre-ln": (dict(extractor_mode="layer_norm", layer_norm_first=True, normalize=True),
                      False),
    "w2v2-base-post-ln": (dict(extractor_mode="default", layer_norm_first=False), False),
    "wavlm": (dict(extractor_mode="layer_norm", layer_norm_first=True, normalize=True), True),
    "wavlm-post-ln": (dict(extractor_mode="default", layer_norm_first=False), True),
}
TRUNK_SITES = ["dropout_input", "dropout", "activation_dropout", "attention_dropout"]
LENS = np.asarray([3200, 1501, 401], np.int32)
def waves(lens=LENS, seed=0):
    rng = np.random.RandomState(seed)
    x = rng.randn(len(lens), max(lens)).astype(np.float32) * 0.1
    return x * (np.arange(max(lens))[None] < np.asarray(lens)[:, None]), np.asarray(lens)


def trunk_configs(family, **fields):
    fam, wavlm = TRUNKS[family]
    fields = dict(WIDTH, **fam, **fields)
    if wavlm:
        return JaxWavLMConfig(**fields), WavLMConfig(**fields), JaxWavLM, WavLMModel
    return JaxConfig(**fields), Wav2Vec2Config(**fields), JaxTrunk, Wav2Vec2Trunk


@pytest.fixture(scope="module")
def trunk_params():
    """Each trunk family's perturbed JAX params (they do not depend on the
    rates)."""
    out = {}
    for family in TRUNKS:
        jcfg, _, jcls, _ = trunk_configs(family)
        init = jax.jit(lambda k, w, n: jcls(jcfg).init(k, w, n, deterministic=True))
        out[family] = perturbed(init(jax.random.key(0), jnp.zeros((1, 3200)),
                                     jnp.asarray([3200]))["params"])
    return out


def jax_trunk_states(family, params, wavs, lens, train, dtype=jnp.float32, flash=False,
                     quantize=False, **fields):
    jcfg, _, jcls, _ = trunk_configs(family, **fields)
    model = jcls(jcfg, dtype=dtype, use_flash=flash, quantize=quantize)
    up = JaxUpstream(
        name=family, params={"params": params},
        apply_fn=lambda v, w, l, train, rngs: model.apply(v, w, l, deterministic=not train,
                                                          rngs=rngs),
        num_layers=jcfg.encoder_layers + 1, hidden_size=jcfg.encoder_embed_dim,
        downsample_rate=STRIDE)
    run = jax.jit(lambda p, w, l, key: up.apply_standardized(
        p, w, l, train, {"dropout": key} if train else None))
    hs, h_lens = run(up.params, jnp.asarray(wavs), jnp.asarray(lens), jax.random.key(3))
    return np.asarray(jnp.asarray(hs, jnp.float32)), np.asarray(h_lens)


def port_trunk(family, params, dtype=torch.float32, flash=False, quantize=False, **fields):
    _, pcfg, _, pcls = trunk_configs(family, **fields)
    model = pcls(pcfg, dtype=dtype, use_flash=flash, quantize=quantize, device="meta")
    model.to_empty(device="cpu")
    convert = wavlm_state_dict_from_jax if TRUNKS[family][1] else trunk_state_dict_from_jax
    model.load_state_dict(convert(params, pcfg))
    return Upstream(name=family, model=model.eval(), num_layers=pcfg.encoder_layers + 1,
                    hidden_size=pcfg.encoder_embed_dim, downsample_rate=STRIDE)


def port_states(up, wavs, lens, train, seed=0):
    hs, h_lens = up(torch.from_numpy(wavs), torch.from_numpy(lens), train=train,
                    generator=torch.Generator().manual_seed(seed))
    return hs.float().numpy(), h_lens.numpy()


def assert_close(got, want, got_lens, want_lens):
    np.testing.assert_array_equal(got_lens, want_lens)
    assert got.shape == want.shape
    for layer in range(got.shape[0]):
        for b, n in enumerate(got_lens):
            n = min(int(n), got.shape[2])
            np.testing.assert_allclose(got[layer, b, :n], want[layer, b, :n], atol=5e-4,
                                       rtol=0, err_msg=f"layer {layer} utterance {b}")


def layer_cosines(got, want, lens):
    out = []
    for layer in range(got.shape[0]):
        a = np.concatenate([got[layer, b, :min(int(n), got.shape[2])] for b, n in
                            enumerate(lens)]).astype(np.float64).ravel()
        b = np.concatenate([want[layer, b, :min(int(n), got.shape[2])] for b, n in
                            enumerate(lens)]).astype(np.float64).ravel()
        out.append(a @ b / (np.linalg.norm(a) * np.linalg.norm(b)))
    return out


@pytest.mark.parametrize("site", TRUNK_SITES)
@pytest.mark.parametrize("family", list(TRUNKS))
def test_trunk_dropout_site_matches_jax(trunk_params, family, site):
    """One rate at 1.0, the others 0, in train mode: the port's states are
    JAX's. ``attention_dropout`` is applied by neither (JAX's
    SelfAttention never uses its rate), so there train mode is eval mode."""
    wavs, lens = waves()
    params = trunk_params[family]
    want, want_lens = jax_trunk_states(family, params, wavs, lens, True, **{site: 1.0})
    up = port_trunk(family, params, **{site: 1.0})
    got, got_lens = port_states(up, wavs, lens, True)
    assert up.model.training
    assert_close(got, want, got_lens, want_lens)
    if site == "attention_dropout":
        evaluated, _ = port_states(up, wavs, lens, False)
        np.testing.assert_array_equal(got, evaluated)
    else:  # the site did something
        assert not np.allclose(got, port_states(up, wavs, lens, False)[0], atol=1e-3)


@pytest.mark.parametrize("family", list(TRUNKS))
def test_trunk_train_mode_at_rates_zero_is_eval_mode(trunk_params, family):
    """All rates 0: train mode equals eval mode, bit for bit, and JAX's
    train mode."""
    wavs, lens = waves(seed=1)
    up = port_trunk(family, trunk_params[family])
    got, got_lens = port_states(up, wavs, lens, True)
    np.testing.assert_array_equal(got, port_states(up, wavs, lens, False)[0])
    want, want_lens = jax_trunk_states(family, trunk_params[family], wavs, lens, True)
    assert_close(got, want, got_lens, want_lens)


def counting(monkeypatch, module, name):
    calls = []
    fn = getattr(module, name)

    def spy(*args, **kwargs):
        calls.append(name)
        return fn(*args, **kwargs)

    monkeypatch.setattr(module, name, spy)
    return calls


@pytest.mark.parametrize("precision", ["bf16", "int8"])
@pytest.mark.parametrize("family", ["hubert-pre-ln", "wavlm"])
def test_flash_train_mode_runs_the_attention_kernel(trunk_params, monkeypatch, family,
                                                    precision):
    """flash=True in train mode: the port's K7 (WavLM: K9) wrapper runs once
    a layer, as JAX's Pallas attention (interpret mode) does in its train
    mode, with no whole-block kernel; the states agree at cosine 0.999."""
    kernel = "gated_bias_attention" if TRUNKS[family][1] else "fused_qkv_attention"
    jax_calls = counting(monkeypatch, jax_fa, kernel)
    port_calls = counting(monkeypatch, port_transformer, kernel)
    blocks = [counting(monkeypatch, port_transformer, name) for name in
              ("fused_attention_block", "fused_attention_block_bf16",
               "fused_qkv_attention_outproj")]
    monkeypatch.setattr(port_transformer, "_fused_block_available", lambda x: True)
    quantize = precision == "int8"
    wavs, lens = waves(seed=2)
    params = trunk_params[family]
    want, want_lens = jax_trunk_states(family, params, wavs, lens, True, dtype=jnp.bfloat16,
                                       flash=True, quantize=quantize)
    up = port_trunk(family, params, torch.bfloat16, flash=True, quantize=quantize)
    got, got_lens = port_states(up, wavs, lens, True)
    np.testing.assert_array_equal(got_lens, want_lens)
    assert len(port_calls) == 2 and jax_calls and not any(blocks)
    assert min(layer_cosines(got, want, got_lens)) > 0.999


def test_layerdrop_raises_in_both(trunk_params):
    """encoder_layerdrop > 0 in train mode: JAX's trainer gives no
    "layerdrop" stream (InvalidRngError), the port raises at the call;
    WavLM reads no layerdrop in either package, and runs."""
    wavs, lens = waves()
    params = trunk_params["hubert-pre-ln"]
    with pytest.raises(flax.errors.InvalidRngError, match="layerdrop"):
        jax_trunk_states("hubert-pre-ln", params, wavs, lens, True, encoder_layerdrop=0.1)
    up = port_trunk("hubert-pre-ln", params, encoder_layerdrop=0.1)
    with pytest.raises(NotImplementedError, match='"layerdrop"'):
        port_states(up, wavs, lens, True)
    port_states(up, wavs, lens, False)  # eval mode runs
    want, want_lens = jax_trunk_states("wavlm", trunk_params["wavlm"], wavs, lens, True,
                                       encoder_layerdrop=0.5)
    got, got_lens = port_states(port_trunk("wavlm", trunk_params["wavlm"],
                                           encoder_layerdrop=0.5), wavs, lens, True)
    assert_close(got, want, got_lens, want_lens)


def test_configs_keep_their_fields():
    """The port's trunk configs carry the JAX configs' rate fields and
    defaults (HuBERT-Large: dropout_input 0.1, the others 0)."""
    from s3prl_tpu.models.hubert import HUBERT_LARGE as JAX_LARGE
    from s3prl_tpu_torch.models.hubert import HUBERT_LARGE

    for name in ("dropout", "attention_dropout", "activation_dropout", "dropout_input",
                 "encoder_layerdrop"):
        assert getattr(HUBERT_LARGE, name) == getattr(JAX_LARGE, name), name
    assert HUBERT_LARGE.dropout_input == 0.1
    assert {f.name for f in dataclasses.fields(WavLMConfig)} >= {
        f.name for f in dataclasses.fields(JaxWavLMConfig)}
