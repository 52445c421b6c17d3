"""The post-LN Base slice of s3prl_tpu_torch vs s3prl_tpu (CPU): HuBERT-Base.

A tiny trunk of the HuBERT-Base family (the default extractor: conv0 ->
per-channel GroupNorm -> GELU, then conv -> GELU; post-LN encoder with its
LayerNorm before the layers; normalize=False), with conv bias as a second
case, is initialised in JAX, every leaf perturbed so that no bias or norm
is trivial, and carried to the port with `trunk_state_dict_from_jax`. The
same numpy batch goes through `Upstream.apply_standardized` of both
packages. Tolerances: f32 per-layer hidden states at atol 5e-4 over valid
frames (the ROADMAP bar); bf16 and int8 per-layer cosine > 0.999 over
valid frames, both packages on the same route (`kernels`: JAX's Pallas
kernels in interpret mode and the port's wrappers, whose plain versions run
on CPU tensors; `plain`: both module paths); lengths exactly equal. The
full HuBERT-Base configuration (12 layers, C 768, H 12) is held against the
port's own f32 model at the JAX package's gates (int8 > 0.999, bf16 >
0.995, tests/test_quant.py:553-591). The load-time refusals, including the
two card limits (the pos-conv's 64 channels a group, the attention's head
dim 64), are checked with `torch.cuda._lazy_init` patched to fail, so a
refusal that reached CUDA fails the test. Every test runs with the JAX
package's default knobs.
"""

import dataclasses

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

import s3prl_tpu.kernels.flash_attention as jax_fa
import s3prl_tpu.kernels.posconv as jax_pc
import s3prl_tpu.models.transformer as jax_transformer
import s3prl_tpu_torch.kernels.flash_attention as port_fa
import s3prl_tpu_torch.models.transformer as port_transformer
from s3prl_tpu.models.wav2vec2 import Wav2Vec2Config as JaxConfig
from s3prl_tpu.models.wav2vec2 import Wav2Vec2Trunk as JaxTrunk
from s3prl_tpu.upstream.base import Upstream as JaxUpstream
from s3prl_tpu.upstream.convert import trunk_params_from_torch
from s3prl_tpu_torch import hub
from s3prl_tpu_torch.kernels import wrappers
from s3prl_tpu_torch.models.transformer import ConvPositionalEmbedding
from s3prl_tpu_torch.models.wav2vec2 import LARGE, Wav2Vec2Config, Wav2Vec2Trunk
from s3prl_tpu_torch.upstream.base import Upstream
from s3prl_tpu_torch.upstream.convert import trunk_state_dict_from_jax
from test_torch_port_slice import (  # noqa: F401 (fixtures)
    _batch, _jax_defaults, _layer_cosines, _valid_frames)

TINY = dict(
    extractor_mode="default",
    conv_feature_layers=((64, 10, 5), (64, 3, 2), (64, 2, 2)),
    encoder_layers=2, encoder_embed_dim=128, encoder_ffn_embed_dim=256,
    encoder_attention_heads=2, conv_pos=16, conv_pos_groups=4,
    layer_norm_first=False, dropout=0.0, attention_dropout=0.0,
    dropout_input=0.0, normalize=False,
)
CASES = {"no-bias": {}, "conv_bias": {"conv_bias": True}}
STRIDE = 20
LENS = [3200, 1501, 1]  # T' = 160 frames; one utterance of a single frame
PRECISION = {"f32": (jnp.float32, torch.float32, False, False),  # (jax, port dtype, flash, quantize)
             "bf16": (jnp.bfloat16, torch.bfloat16, True, False),
             "int8": (jnp.bfloat16, torch.bfloat16, True, True)}


def perturbed(params):
    rng = np.random.RandomState(0)
    return jax.tree_util.tree_map(
        lambda a: np.asarray(a, np.float32) + 0.05 * rng.randn(*np.shape(a)).astype(np.float32),
        params)


def jax_init(model):
    """The JAX model's params (jitted init), every leaf perturbed."""
    init = jax.jit(lambda key, w, n: model.init(key, w, n, deterministic=True))
    return perturbed(init(jax.random.key(0), jnp.zeros((1, 3200)), jnp.asarray([3200]))["params"])


@pytest.fixture(scope="module")
def params():
    return {case: jax_init(JaxTrunk(JaxConfig(**TINY, **extra))) for case, extra in CASES.items()}


def run_jax(model, params, wavs, lens):
    """`model` (a JAX module) through the JAX Upstream, jitted afresh (the
    patched thresholds and availability are read while it traces)."""
    apply = jax.jit(lambda v, w, n: model.apply(v, w, n, deterministic=True))
    up = JaxUpstream(name="tiny", params={"params": params},
                     apply_fn=lambda v, w, n, train, rngs: apply(v, w, n),
                     num_layers=model.cfg.encoder_layers + 1,
                     hidden_size=model.cfg.encoder_embed_dim, downsample_rate=STRIDE)
    hs, h_lens = up.apply_standardized(up.params, jnp.asarray(wavs), jnp.asarray(lens))
    return np.asarray(jnp.asarray(hs, jnp.float32)), np.asarray(h_lens)


def port_upstream(model, state_dict):
    """A port model built on meta, loaded (building its int8 cache), in eval mode."""
    model.to_empty(device="cpu")
    model.load_state_dict(state_dict)
    cfg = model.cfg
    return Upstream(name="tiny", model=model.eval(), num_layers=cfg.encoder_layers + 1,
                    hidden_size=cfg.encoder_embed_dim, downsample_rate=STRIDE)


def run_port(up, wavs, lens):
    hs, h_lens = up.apply_standardized(torch.from_numpy(wavs), torch.from_numpy(lens))
    return hs.float().numpy(), h_lens.numpy()


def kernels_on(monkeypatch, **thresholds):
    """Both packages take their kernel routes on the CPU, with `thresholds`
    (MAX_BLOCK_T, MAX_KERNEL_T) patched in both kernels modules."""
    monkeypatch.setattr(jax_transformer, "_fused_block_available", lambda: True)
    monkeypatch.setattr(port_transformer, "_fused_block_available", lambda x: True)
    for name, value in thresholds.items():
        for fa in (jax_fa, port_fa):
            monkeypatch.setattr(fa, name, value)


def spy(monkeypatch, module, name):
    """Replaces module.name by a wrapper that counts its calls."""
    calls, fn = [], getattr(module, name)
    monkeypatch.setattr(module, name, lambda *a, **k: calls.append(1) or fn(*a, **k))
    return calls


def assert_f32_close(got, want, got_lens, want_lens):
    np.testing.assert_array_equal(got_lens, want_lens)
    assert got.shape == want.shape
    for layer in range(got.shape[0]):
        for b, n in enumerate(_valid_frames(got_lens, got.shape[2])):
            np.testing.assert_allclose(got[layer, b, :n], want[layer, b, :n], atol=5e-4,
                                       err_msg=f"layer {layer} utterance {b}")


def assert_cos(got, want, got_lens, want_lens, bar=0.999):
    np.testing.assert_array_equal(got_lens, want_lens)
    assert got.shape == want.shape
    coss = _layer_cosines(got, want, got_lens)
    assert min(coss) > bar, coss


def _jax(params, case, wavs, lens, precision="f32"):
    dtype, _, flash, quantize = PRECISION[precision]
    model = JaxTrunk(JaxConfig(**TINY, **CASES[case]), dtype=dtype, use_flash=flash,
                     quantize=quantize)
    return run_jax(model, params[case], wavs, lens)


def _port(params, case, precision="f32", **options):
    _, dtype, flash, quantize = PRECISION[precision]
    cfg = Wav2Vec2Config(**TINY, **CASES[case])
    model = Wav2Vec2Trunk(cfg, dtype=dtype, use_flash=flash, quantize=quantize, device="meta",
                          **options)
    return port_upstream(model, trunk_state_dict_from_jax(params[case], cfg))


# -- parity with the JAX package ----------------------------------------------------

@pytest.mark.parametrize("case", CASES)
def test_base_f32_matches_jax(params, case):
    wavs, lens = _batch(31, LENS)
    want, want_lens = _jax(params, case, wavs, lens)
    got, got_lens = run_port(_port(params, case), wavs, lens)
    assert got.shape == (3, 3, 160, 128)
    assert_f32_close(got, want, got_lens, want_lens)


@pytest.mark.parametrize("route", ["kernels", "plain"])
@pytest.mark.parametrize("precision", ["bf16", "int8"])
def test_base_reduced_precision_matches_jax(params, monkeypatch, precision, route):
    """`kernels`: JAX runs K1 / K4 postnorm and K2 / K5 postnorm (interpret
    mode), the port its wrappers; `plain`: both module paths (K7 between the
    projections, erf FFN)."""
    if route == "kernels":
        kernels_on(monkeypatch)
        block = spy(monkeypatch, port_fa, "fused_attention_block_reference" if precision == "int8"
                    else "fused_attention_block_bf16_reference")
    wavs, lens = _batch(32, LENS)
    want, want_lens = _jax(params, "no-bias", wavs, lens, precision)
    got, got_lens = run_port(_port(params, "no-bias", precision), wavs, lens)
    assert_cos(got, want, got_lens, want_lens)
    if route == "kernels":
        assert len(block) == 2  # one per layer


LONG = {  # route -> (precision, MAX_KERNEL_T, the port's plain version that must run)
    "int8-k6": ("int8", 2048, "fused_qkv_attention_outproj_reference"),
    "int8-k8": ("int8", 128, "online_flash_attention_reference"),
    "bf16-k7": ("bf16", 2048, "fused_qkv_attention_reference"),
    "bf16-k8": ("bf16", 128, "online_flash_attention_reference"),
}


@pytest.mark.parametrize("route", LONG)
def test_base_long_routes_match_jax(params, monkeypatch, route):
    """T' = 160 frames with MAX_BLOCK_T = 64 in both packages: int8 through
    the post-LN split (int8 QKV on raw x, K6 or with MAX_KERNEL_T = 128 K8,
    the stock LN) and K2 postnorm, as tests/test_quant.py:593 routes it;
    bf16 through the module path's K7 (or K8) and K5 postnorm."""
    precision, max_kernel_t, plain = LONG[route]
    kernels_on(monkeypatch, MAX_BLOCK_T=64, MAX_KERNEL_T=max_kernel_t)
    calls = spy(monkeypatch, port_fa, plain)
    wavs, lens = _batch(33, LENS)
    want, want_lens = _jax(params, "no-bias", wavs, lens, precision)
    got, got_lens = run_port(_port(params, "no-bias", precision), wavs, lens)
    assert len(calls) == 2  # one per layer
    assert_cos(got, want, got_lens, want_lens)


def test_base_state_dict_round_trip_is_exact(params):
    """The port's state_dict (f32 and int8 models) carries the group-norm
    keys ``conv_layers.0.2.{weight,bias}`` and the conv biases, and maps
    back to the JAX tree bit for bit."""
    for case, extra in CASES.items():
        cfg, jcfg = Wav2Vec2Config(**TINY, **extra), JaxConfig(**TINY, **extra)
        sd = trunk_state_dict_from_jax(params[case], cfg)
        assert "feature_extractor.conv_layers.0.2.weight" in sd
        assert ("feature_extractor.conv_layers.1.0.bias" in sd) == bool(extra)
        flat_b = dict(jax.tree_util.tree_leaves_with_path(params[case]))
        for quantize in (False, True):  # the int8 model keeps f32 weights
            model = Wav2Vec2Trunk(cfg, quantize=quantize, device="meta")
            port_sd = port_upstream(model, sd).model.state_dict()
            assert port_sd.keys() == sd.keys()
            tree = trunk_params_from_torch(port_sd, jcfg)
            flat_a = jax.tree_util.tree_leaves_with_path(tree)
            assert len(flat_a) == len(flat_b)
            for path, leaf in flat_a:
                np.testing.assert_array_equal(leaf, flat_b[path], err_msg=str(path))


# -- the full configuration against the port's f32 model ------------------------------

@pytest.mark.parametrize("name", ["hubert_base", "wavlm_base"])
def test_full_base_quality_against_f32(monkeypatch, name):
    """hub.load(name) at full width and depth (12 layers, C 768, H 12) on
    B=2 x 0.5 s, the batch of tests/test_quant.py:553-591: int8 serving
    (K1 / K2 postnorm for HuBERT, K9 and K2 bare for WavLM) per-layer cosine
    > 0.999 and bf16 (K4 / K5 postnorm; WavLM K9) > 0.995 against the f32
    model of the same weights."""
    rng = np.random.RandomState(13)
    wavs = torch.from_numpy(rng.randn(2, 8000).astype(np.float32))
    lens = torch.tensor([8000, 6400])
    want, want_lens = hub.load(name, device="cpu").apply_standardized(wavs, lens)
    assert want.shape == (13, 2, 25, 768)
    monkeypatch.setattr(port_transformer, "_fused_block_available", lambda x: True)
    for quantize, bar in ((True, 0.999), (False, 0.995)):
        up = hub.load(name, dtype=torch.bfloat16, flash=True, quantize=quantize, device="cpu")
        got, got_lens = up.apply_standardized(wavs, lens)
        assert_cos(got.float().numpy(), want.numpy(), got_lens.numpy(), want_lens.numpy(), bar)


# -- the load-time refusals -------------------------------------------------------------

@pytest.fixture
def no_cuda(monkeypatch):
    """Any step that reaches CUDA fails the test."""
    monkeypatch.setattr(torch.cuda, "_lazy_init", lambda: pytest.fail("CUDA was touched"))


@pytest.mark.parametrize("name,kwargs,match", [
    ("hubert_base", dict(int8_conv=True), "int8_conv cannot take effect"),
    ("hubert_base", dict(fused_conv=True), "fused_conv cannot take effect"),
    ("hubert_base", dict(fused_midln=True), "fused_midln cannot take effect"),
    ("wavlm_base", dict(fused_conv=True), "fused_conv cannot take effect"),
    ("wavlm_base_plus", dict(fused_midln=True), "fused_midln cannot take effect"),
    ("hubert", dict(qkv_fuse=True), "qkv_fuse cannot take effect.*post-LN"),
    ("hubert_base", dict(full_fuse=True), "full_fuse cannot take effect.*post-LN"),
    ("wavlm", dict(qkv_fuse=True), "qkv_fuse cannot take effect"),
])
def test_base_options_refuse_what_cannot_take_effect(no_cuda, name, kwargs, match):
    """The front-end options need the layer-norm extractor; qkv_fuse and
    full_fuse fuse the pre-LN block. At load, before any weight is made."""
    with pytest.raises(ValueError, match=match):
        hub.load(name, dtype=torch.bfloat16, flash=True, quantize=True, device="cpu", **kwargs)


@pytest.mark.parametrize("option", ["fused", "int8"])
@pytest.mark.parametrize("C,G", [(768, 16), (1024, 8)])
def test_posconv_option_off_the_card_group_width_refuses_at_load(no_cuda, option, C, G):
    """A pos-conv option built for the card at other than 64 channels a
    group raises at load, naming the width, before anything touches CUDA;
    built on the CPU (the plain version takes any width) it is made."""
    for device in ("cuda", torch.device("cuda", 0)):
        with pytest.raises(ValueError, match=f"64 channels a group, got {C} channels in {G}"):
            ConvPositionalEmbedding(C, 128, G, option=option, device=device)
    mod = ConvPositionalEmbedding(C, 128, G, option=option, device="cpu")
    assert mod[0].weight.shape == (C, C // G, 128)


@pytest.mark.parametrize("name,option", [("hubert_base", "int8_posconv"),
                                         ("wavlm_base", "fused_posconv")])
def test_base_posconv_options_refuse_the_card(no_cuda, name, option):
    """hub.load of a Base model for the card (768 channels in 16 groups)
    with a pos-conv option raises before CUDA is touched; on the CPU it loads."""
    with pytest.raises(ValueError, match="64 channels a group, got 768 channels in 16"):
        hub.load(name, dtype=torch.bfloat16, flash=True, device="cuda", **{option: True})
    up = hub.load(name, dtype=torch.bfloat16, flash=True, device="cpu", **{option: True})
    assert up.model.encoder.pos_conv.option == option.split("_")[0]


def test_flash_off_the_card_head_dim_refuses_at_load(no_cuda):
    """A pre-LN flash trunk at C = 1,024 and H = 8 (head dim 128) built for
    the card raises at load, naming the limit, before CUDA is touched; on
    the CPU it is made, and so is the card's trunk without flash."""
    cfg = dataclasses.replace(LARGE, encoder_attention_heads=8)
    for device in ("cuda", torch.device("cuda", 0)):
        with pytest.raises(ValueError, match="head dim 64, got 1024 channels in 8 heads"):
            Wav2Vec2Trunk(cfg, dtype=torch.bfloat16, use_flash=True, quantize=True,
                          device=device)
    Wav2Vec2Trunk(cfg, dtype=torch.bfloat16, use_flash=True, quantize=True, device="meta")
    model = Wav2Vec2Trunk(cfg, dtype=torch.bfloat16, use_flash=False, device="meta")
    assert model.encoder.layers[0].num_heads == 8


def test_posconv_q8_at_48_channels_a_group_matches_jax():
    """``int8_posconv`` on the CPU at C/G = 48 (the Base models' 768 / 16,
    here 96 / 2): the plain version of K16b against the JAX kernel in
    interpret mode, on the same numpy inputs (atol 2e-5, the bar of
    tests/test_torch_port_posconv.py for the same f32 arithmetic)."""
    C, G, k, T = 96, 2, 32, 45
    rng = np.random.RandomState(34)
    x = rng.randn(2, T, C).astype(np.float32)
    kern = (rng.randn(k, C // G, C) * (k * C // G) ** -0.5).astype(np.float32)
    bias = (rng.randn(C) * 0.1).astype(np.float32)
    mod = ConvPositionalEmbedding(C, k, G, option="int8", device="cpu").eval()
    mod.load_state_dict({"0.weight": torch.from_numpy(kern.transpose(2, 1, 0).copy()),
                         "0.bias": torch.from_numpy(bias)})
    with torch.no_grad():
        got = mod(torch.from_numpy(x))
    want = jax_pc.pos_conv_gelu_q8(jnp.asarray(x), jnp.asarray(kern), jnp.asarray(bias),
                                   groups=G, interpret=True)
    assert tuple(got.shape) == (2, T, C)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=2e-5, rtol=0)


# -- train() ----------------------------------------------------------------------------

@pytest.mark.parametrize("precision", ["bf16", "int8"])
def test_train_mode_post_ln_layer_takes_module_path(params, monkeypatch, precision):
    """A post-LN layer in train() mode calls no block kernel wrapper (K1,
    K2, K4, K5, K6 are forward-only; the JAX `deterministic` gates them),
    gradients reach its weights, and its values equal the eval-mode module
    path's."""
    def refuse(*args, **kwargs):
        raise AssertionError("a forward-only block kernel in train() mode")

    monkeypatch.setattr(port_transformer, "_fused_block_available", lambda x: True)
    for name in ("fused_attention_block", "fused_attention_block_bf16", "fused_int8_ffn",
                 "fused_bf16_ffn", "fused_qkv_attention_outproj"):
        monkeypatch.setattr(port_transformer, name, refuse)
    layer = _port(params, "no-bias", precision).model.encoder.layers[0].train()
    x = torch.from_numpy(np.random.RandomState(35).randn(2, 50, 128).astype(np.float32))
    x = x.bfloat16()
    kv = torch.tensor([50, 20], dtype=torch.int32)
    pad = torch.arange(50)[None, :] >= kv[:, None]
    got = layer(x, kv, pad)
    got.float().sum().backward()
    assert layer.fc1.bias.grad is not None and layer.self_attn.qkv_bias.grad is not None
    monkeypatch.setattr(port_transformer, "_fused_block_available", lambda x: False)
    with torch.no_grad():
        assert torch.equal(got.detach(), layer.eval()(x, kv, pad))


def test_cpu_base_run_counts_no_launch(params):
    before = [w.launches for w in wrappers()]
    wavs, lens = _batch(36, [3200, 1600])
    run_port(_port(params, "no-bias", "int8"), wavs, lens)
    assert [w.launches for w in wrappers()] == before
