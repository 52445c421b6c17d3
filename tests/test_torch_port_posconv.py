"""The pos-conv options and K17 in s3prl_tpu_torch vs s3prl_tpu (CPU).

K16a `pos_conv_gelu`, K16b `pos_conv_gelu_q8` and K17 `flash_attention`: the
port's wrappers on CPU tensors (their plain versions) against the JAX
functions with their Pallas kernels in interpret mode, on the same numpy
inputs; K16b's int8 codes and scales against the JAX computation of
posconv.py:121-135. Then the options that route through K16a/K16b, the
port's keywords against the JAX switch: the tiny HuBERT-Large-style trunk of
`test_torch_port_slice.py` and the tiny WavLM of `test_torch_port_wavlm.py`,
both with conv_pos = 32 (K16b's tap chunk), with ``fused_posconv``
(S3PRL_POSCONV=pallas) and ``int8_posconv`` (S3PRL_POSCONV=pallas_q8). Spies
on the JAX kernel functions and on the port's plain versions prove that both
took the kernel route. Last, the routing (MAX_POSCONV_T, train()) and the
keywords' refusals and state. Tolerances:
- K16a and K17 with f32 inputs at atol 2e-5 (the bar of
  tests/test_kernels.py:15-50, :324: sums in another order); K16b's f32
  output at atol 1e-5 (its sums are exact; only the erf differs, the A&S
  polynomial's 1.5e-7); bf16 outputs within one bf16 step (a value near a
  rounding boundary can land one step apart), with a floor of 1e-6 near 0;
- K16b's codes, scales and rescale products: bit for bit;
- the models: f32 per-layer hidden states at atol 5e-4 over valid frames,
  bf16 and int8 per-layer cosine > 0.999 (the bars of
  `test_torch_port_frontend.py`), the int8 option against the port's own
  f32 model at cosine > 0.999 (the JAX package's int8 gate); lengths exact;
- routes that must agree bit for bit (the stock conv under the patched
  threshold and in train()): torch.equal.
"""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

import s3prl_tpu.kernels.flash_attention as jax_fa
import s3prl_tpu.kernels.posconv as jax_pc
import s3prl_tpu.models.transformer as jax_transformer
import s3prl_tpu_torch.kernels.flash_attention as port_fa
import s3prl_tpu_torch.kernels.posconv as port_pc
import s3prl_tpu_torch.models.transformer as port_transformer
import test_torch_port_slice as hubert_tests
import test_torch_port_wavlm as wavlm_tests
from s3prl_tpu.models.wav2vec2 import Wav2Vec2Config as JaxConfig
from s3prl_tpu.models.wav2vec2 import Wav2Vec2Trunk as JaxTrunk
from s3prl_tpu.models.wavlm import WavLMConfig as JaxWavLMConfig
from s3prl_tpu.models.wavlm import WavLMModel as JaxWavLM
from s3prl_tpu.upstream.base import Upstream as JaxUpstream
from s3prl_tpu_torch import hub
from s3prl_tpu_torch.models.transformer import ConvPositionalEmbedding
from s3prl_tpu_torch.models.wav2vec2 import Wav2Vec2Config, Wav2Vec2Trunk
from s3prl_tpu_torch.models.wavlm import WavLMConfig, WavLMModel
from s3prl_tpu_torch.upstream.base import Upstream
from s3prl_tpu_torch.upstream.convert import trunk_state_dict_from_jax, wavlm_state_dict_from_jax
from test_torch_port_slice import _batch, _layer_cosines, _valid_frames
from test_torch_port_wavlm import _spy

DTYPES = {"f32": (jnp.float32, torch.float32), "bf16": (jnp.bfloat16, torch.bfloat16)}
# path -> (JAX dtype, port dtype, flash, quantize)
PATHS = {"f32": (jnp.float32, torch.float32, False, False),
         "bf16": (jnp.bfloat16, torch.bfloat16, True, False),
         "int8": (jnp.bfloat16, torch.bfloat16, True, True)}
# option -> the JAX switch's value, the JAX kernel function, the port's plain version
OPTIONS = {"fused_posconv": ("pallas", "pos_conv_gelu", "pos_conv_gelu_reference"),
           "int8_posconv": ("pallas_q8", "pos_conv_gelu_q8", "pos_conv_gelu_q8_reference")}


@pytest.fixture(autouse=True)
def _knobs_off(monkeypatch):
    """Every test starts from the JAX package's defaults."""
    for name in ("S3PRL_POSCONV",) + hubert_tests.JAX_KNOBS:
        monkeypatch.delenv(name, raising=False)


def _np(x):
    return np.asarray(x.float() if isinstance(x, torch.Tensor) else jnp.asarray(x, jnp.float32),
                      np.float64)


def _within_one_bf16_step(got, want):
    got, want = _np(got), _np(want)
    step = np.exp2(np.floor(np.log2(np.maximum(np.abs(want), 2.0 ** -126))) - 7)
    err = np.abs(got - want)
    assert (err <= np.maximum(step, 1e-6)).all(), err.max()


def _conv_inputs(seed, T, B=2, C=128, G=4, k=32):
    """x [B, T, C], a JAX-layout kernel [k, C/G, C], the port's nn.Conv1d
    weight [C, C/G, k] of the same values, a bias."""
    rng = np.random.RandomState(seed)
    x = rng.randn(B, T, C).astype(np.float32)
    kern = (rng.randn(k, C // G, C) / np.sqrt(k * C // G)).astype(np.float32)
    bias = (0.1 * rng.randn(C)).astype(np.float32)
    return x, kern, torch.from_numpy(np.ascontiguousarray(kern.transpose(2, 1, 0))), bias


# -- the kernels --------------------------------------------------------------------

@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("T", [53, 1, 127, 128, 129, 256, 257])
def test_k16a_plain_matches_interpreted_pallas(T, dtype):
    """C=128, 4 groups, k=32, same padding, last frame dropped; the weight as
    the nn.Conv1d weight and as the load-time tap-major GEMM weight; T on and
    beside the CUDA kernel's 128-row window boxes and 256-frame blocks."""
    jdt, tdt = DTYPES[dtype]
    x, kern, weight, bias = _conv_inputs(0, T)
    want = jax_pc.pos_conv_gelu(jnp.asarray(x, jdt), jnp.asarray(kern), jnp.asarray(bias),
                                groups=4, interpret=True)
    xt, bt = torch.from_numpy(x).to(tdt), torch.from_numpy(bias)
    for w in (weight.to(tdt), port_pc.posconv_gemm_weight(weight.to(tdt), 4)):
        got = port_pc.pos_conv_gelu(xt, w, bt, 4)
        assert got.dtype == tdt and tuple(got.shape) == (2, T, 128)
        if dtype == "f32":
            np.testing.assert_allclose(_np(got), _np(want), atol=2e-5, rtol=0)
        else:
            _within_one_bf16_step(got, want)


def test_k16b_codes_and_scales_equal_jax():
    """posconv.py:121-135 computed in JAX (the padded shift stack's
    per-(batch, group) scale and codes, the per-(group, out channel) weight
    codes and scales from f32, the pre-multiplied rescale) against the
    port's `quantize_posconv_input`, `quantize_posconv_weight` and the f32
    products its plain version and kernel form: bit for bit."""
    x, kern, weight, _ = _conv_inputs(1, 53)
    B, T, C = x.shape
    G, k, tc = 4, 32, jax_pc.TC_Q8
    cg = C // G
    x_pad = jnp.pad(jnp.asarray(x), ((0, 0), (k // 2, k // 2 - 1), (0, 0)))
    xsh, _ = jax_pc._shift_stack(x_pad, B, T, G, cg, k, tc)
    amax = jnp.max(jnp.abs(xsh.astype(jnp.float32)), axis=(2, 3))
    xs = jnp.maximum(amax, 1e-8) / 127.0
    xq = jnp.clip(jnp.round(xsh / xs[:, :, None, None]), -127, 127).astype(jnp.int8)
    wg = jax_pc._tap_major_weights(jnp.asarray(kern), k, cg, G)
    ws = jnp.maximum(jnp.max(jnp.abs(wg), axis=1, keepdims=True), 1e-8) / 127.0
    wq = jnp.clip(jnp.round(wg / ws), -127, 127).astype(jnp.int8)
    sc = xs[:, :, None, None] * ws[None]

    got_q, got_xs = port_pc.quantize_posconv_input(torch.from_numpy(x), G)
    np.testing.assert_array_equal(got_xs.numpy(), np.asarray(xs))
    q_pad = jnp.pad(jnp.asarray(got_q.numpy()), ((0, 0), (k // 2, k // 2 - 1), (0, 0)))
    np.testing.assert_array_equal(np.asarray(jax_pc._shift_stack(q_pad, B, T, G, cg, k, tc)[0]),
                                  np.asarray(xq))
    got_wq, got_ws = port_pc.quantize_posconv_weight(weight, G)
    np.testing.assert_array_equal(got_wq.numpy(), np.asarray(wq).transpose(0, 2, 1))
    np.testing.assert_array_equal(got_ws.numpy(), np.asarray(ws)[:, 0])
    np.testing.assert_array_equal((got_xs[:, :, None] * got_ws[None]).numpy(),
                                  np.asarray(sc)[:, :, 0])


@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("T", [53, 1])
def test_k16b_test_mode_returns_the_codes_and_scales_of_jax(T, dtype):
    """`pos_conv_gelu_q8(..., codes=True)` on the CPU: the output of the
    plain call, and the activation codes and scales that JAX's kernel
    wrapper builds in its padded shift stack (posconv.py:121-126), bit for
    bit (on the card the conv kernel writes the codes its windows hold)."""
    jdt, tdt = DTYPES[dtype]
    x, _, weight, bias = _conv_inputs(3, T)
    B, _, C = x.shape
    G, k, tc = 4, 32, jax_pc.TC_Q8
    xj = jnp.asarray(x, jdt)
    x_pad = jnp.pad(xj, ((0, 0), (k // 2, k // 2 - 1), (0, 0)))
    xsh, _ = jax_pc._shift_stack(x_pad, B, T, G, C // G, k, tc)
    xs = jnp.maximum(jnp.max(jnp.abs(xsh.astype(jnp.float32)), axis=(2, 3)), 1e-8) / 127.0
    want_q = jnp.clip(jnp.round(xj.astype(jnp.float32).reshape(B, T, G, C // G)
                                / xs[:, None, :, None]), -127, 127).astype(jnp.int8)
    xt, bt = torch.from_numpy(x).to(tdt), torch.from_numpy(bias)
    out, q, got_xs = port_pc.pos_conv_gelu_q8(xt, weight, bt, G, codes=True)
    assert torch.equal(out, port_pc.pos_conv_gelu_q8(xt, weight, bt, G))
    np.testing.assert_array_equal(got_xs.numpy(), np.asarray(xs))
    np.testing.assert_array_equal(q.numpy(), np.asarray(want_q).reshape(B, T, C))


@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("T", [53, 1])
def test_k16b_plain_matches_interpreted_pallas(T, dtype):
    """The int8 twin on the same shapes; the weight as the f32 nn.Conv1d
    weight (quantized inside) and as the load-time (codes, scales) pair."""
    jdt, tdt = DTYPES[dtype]
    x, kern, weight, bias = _conv_inputs(2, T)
    want = jax_pc.pos_conv_gelu_q8(jnp.asarray(x, jdt), jnp.asarray(kern), jnp.asarray(bias),
                                   groups=4, interpret=True)
    xt, bt = torch.from_numpy(x).to(tdt), torch.from_numpy(bias)
    for w in (weight, port_pc.quantize_posconv_weight(weight, 4)):
        got = port_pc.pos_conv_gelu_q8(xt, w, bt, 4)
        assert got.dtype == tdt and tuple(got.shape) == (2, T, 128)
        if dtype == "f32":
            np.testing.assert_allclose(_np(got), _np(want), atol=1e-5, rtol=0)
        else:
            _within_one_bf16_step(got, want)


def _attn_inputs(seed, B, H, T, Dh):
    rng = np.random.RandomState(seed)
    q, k, v = (rng.randn(B, H, T, Dh).astype(np.float32) * s for s in (Dh ** -0.5, 1, 1))
    return q, k, v, np.array([T, (T * 3) // 5, 1][:B], np.int32)


@pytest.mark.parametrize("dtype,Dh", [("f32", 32), ("bf16", 64)])
@pytest.mark.parametrize("route,max_kernel_t", [("k17", 2048), ("k8", 128)])
def test_k17_plain_matches_interpreted_pallas(monkeypatch, route, max_kernel_t, dtype, Dh):
    """[2, 4, 150, Dh] with kv_lens [150, 90]: K17's own cell, then with
    MAX_KERNEL_T = 128 patched in both packages, where both hand over to K8
    (the spies prove each route); every query row compared."""
    for fa in (jax_fa, port_fa):
        monkeypatch.setattr(fa, "MAX_KERNEL_T", max_kernel_t)
    jdt, tdt = DTYPES[dtype]
    q, k, v, kv = _attn_inputs(3, 2, 4, 150, Dh)
    jax_online = _spy(monkeypatch, jax_fa, "online_flash_attention")
    plain = {name: _spy(monkeypatch, port_fa, name)
             for name in ("flash_attention_reference", "online_flash_attention_reference")}
    want = jax_fa.flash_attention(*(jnp.asarray(a, jdt) for a in (q, k, v)), jnp.asarray(kv),
                                  interpret=True)
    got = port_fa.flash_attention(*(torch.from_numpy(a).to(tdt) for a in (q, k, v)),
                                  torch.from_numpy(kv))
    online = route == "k8"
    assert len(jax_online) == online
    assert {n: len(c) for n, c in plain.items()} == {"flash_attention_reference": int(not online),
                                                     "online_flash_attention_reference": online}
    assert got.dtype == tdt and got.shape == q.shape
    if dtype == "f32":
        np.testing.assert_allclose(_np(got), _np(want), atol=2e-5, rtol=0)
    else:
        _within_one_bf16_step(got, want)


# -- the options through the models -------------------------------------------------

HUBERT = dict(hubert_tests.TINY, conv_pos=32)
WAVLM = dict(wavlm_tests.TINY, conv_pos=32)
MODELS = {  # name -> (JAX class, JAX config, port class, port config, converter, lengths)
    "hubert": (JaxTrunk, JaxConfig(**HUBERT), Wav2Vec2Trunk, Wav2Vec2Config(**HUBERT),
               trunk_state_dict_from_jax, [6400, 3001, 1]),
    "wavlm": (JaxWavLM, JaxWavLMConfig(**WAVLM), WavLMModel, WavLMConfig(**WAVLM),
              wavlm_state_dict_from_jax, wavlm_tests.LENS),
}


@pytest.fixture(scope="module")
def params():
    """Each model's random JAX params, every leaf perturbed by numpy noise."""
    out = {}
    for name, (jax_cls, cfg, *_) in MODELS.items():
        init = jax.jit(lambda key, w, n, m=jax_cls(cfg): m.init(key, w, n, deterministic=True))
        tree = init(jax.random.key(0), jnp.zeros((1, 3200)), jnp.asarray([3200]))["params"]
        rng = np.random.RandomState(0)
        out[name] = jax.tree_util.tree_map(
            lambda a: np.asarray(a, np.float32)
            + 0.05 * rng.randn(*np.shape(a)).astype(np.float32), tree)
    return out


def _run_jax(model, path, params, wavs, lens):
    """The JAX model jitted afresh: S3PRL_POSCONV is read while it traces."""
    jax_cls, cfg = MODELS[model][:2]
    dtype, _, flash, quantize = PATHS[path]
    m = jax_cls(cfg, dtype=dtype, use_flash=flash, quantize=quantize)
    apply = jax.jit(lambda v, w, n: m.apply(v, w, n, deterministic=True))
    up = JaxUpstream(name="tiny", params={"params": params},
                     apply_fn=lambda v, w, n, train, rngs: apply(v, w, n),
                     num_layers=cfg.encoder_layers + 1, hidden_size=cfg.encoder_embed_dim,
                     downsample_rate=hubert_tests.STRIDE)
    hs, h_lens = up.apply_standardized(up.params, jnp.asarray(wavs), jnp.asarray(lens))
    return np.asarray(jnp.asarray(hs, jnp.float32)), np.asarray(h_lens)


def _port(model, path, params, **options):
    _, _, port_cls, cfg, convert, _ = MODELS[model]
    _, dtype, flash, quantize = PATHS[path]
    m = port_cls(cfg, dtype=dtype, use_flash=flash, quantize=quantize, device="meta", **options)
    m.to_empty(device="cpu")
    m.load_state_dict(convert(params, cfg))  # builds the int8 and pos-conv caches
    return Upstream(name="tiny", model=m.eval(), num_layers=cfg.encoder_layers + 1,
                    hidden_size=cfg.encoder_embed_dim, downsample_rate=hubert_tests.STRIDE)


def _run_port(up, wavs, lens):
    hs, h_lens = up.apply_standardized(torch.from_numpy(wavs), torch.from_numpy(lens))
    return hs.float().numpy(), h_lens.numpy()


CASES = [("hubert", "f32", "fused_posconv"), ("hubert", "f32", "int8_posconv"),
         ("hubert", "bf16", "fused_posconv"), ("hubert", "int8", "int8_posconv"),
         ("wavlm", "f32", "fused_posconv"), ("wavlm", "int8", "int8_posconv")]


@pytest.mark.parametrize("model,path,option", CASES, ids=["-".join(c) for c in CASES])
def test_option_matches_jax(params, monkeypatch, model, path, option):
    """The keyword against the JAX switch, both packages on their kernel
    routes; the spies prove one pos-conv kernel call on each side and none
    of the other kernel."""
    switch, jax_fn, plain = OPTIONS[option]
    monkeypatch.setenv("S3PRL_POSCONV", switch)
    monkeypatch.setattr(jax_transformer, "_fused_block_available", lambda: True)
    monkeypatch.setattr(port_transformer, "_fused_block_available", lambda x: True)
    jax_calls = {name: _spy(monkeypatch, jax_pc, name)
                 for name in ("pos_conv_gelu", "pos_conv_gelu_q8")}
    port_calls = {name: _spy(monkeypatch, port_pc, name)
                  for name in ("pos_conv_gelu_reference", "pos_conv_gelu_q8_reference")}
    wavs, lens = _batch(41, MODELS[model][5])
    want, want_lens = _run_jax(model, path, params[model], wavs, lens)
    got, got_lens = _run_port(_port(model, path, params[model], **{option: True}), wavs, lens)
    np.testing.assert_array_equal(got_lens, want_lens)
    assert got.shape == want.shape
    assert {n: len(c) for n, c in jax_calls.items()} == {n: int(n == jax_fn) for n in jax_calls}
    assert {n: len(c) for n, c in port_calls.items()} == {n: int(n == plain) for n in port_calls}
    if path == "f32":
        for b, n in enumerate(_valid_frames(got_lens, got.shape[2])):
            np.testing.assert_allclose(got[:, b, :n], want[:, b, :n], atol=5e-4, rtol=0)
    else:
        coss = _layer_cosines(got, want, got_lens)
        assert min(coss) > 0.999, coss


@pytest.mark.parametrize("model", MODELS)
def test_int8_posconv_quality_against_f32(params, monkeypatch, model):
    """int8 serving with ``int8_posconv`` against the port's own f32 model
    on the same weights: per-layer cosine > 0.999 (the JAX package's int8
    gate, tests/test_quant.py:82-124)."""
    monkeypatch.setattr(port_transformer, "_fused_block_available", lambda x: True)
    wavs, lens = _batch(42, [6400, 4800])
    want, want_lens = _run_port(_port(model, "f32", params[model]), wavs, lens)
    got, got_lens = _run_port(_port(model, "int8", params[model], int8_posconv=True), wavs, lens)
    np.testing.assert_array_equal(got_lens, want_lens)
    coss = _layer_cosines(got, want, got_lens)
    assert min(coss) > 0.999, coss


# -- routing and state ----------------------------------------------------------------

@pytest.mark.parametrize("option", OPTIONS)
def test_beyond_max_posconv_t_the_stock_conv_runs(params, monkeypatch, option):
    """With MAX_POSCONV_T patched below T' = 320 the option's model takes
    the stock conv and equals the option-less model bit for bit (the f32
    weight of ``int8_posconv`` is cast to bf16 at use, as the stock model
    stores it); at the real threshold it takes the kernel."""
    monkeypatch.setattr(port_transformer, "_fused_block_available", lambda x: True)
    plain = _spy(monkeypatch, port_pc, OPTIONS[option][2])
    wavs, lens = _batch(43, [6400, 3001])
    up = _port("hubert", "int8", params["hubert"], **{option: True})
    _run_port(up, wavs, lens)
    assert len(plain) == 1
    monkeypatch.setattr(port_pc, "MAX_POSCONV_T", 300)
    got, _ = _run_port(up, wavs, lens)
    want, _ = _run_port(_port("hubert", "int8", params["hubert"]), wavs, lens)
    assert len(plain) == 1
    np.testing.assert_array_equal(got, want)


def _refuse(*args, **kwargs):
    raise AssertionError("a pos-conv kernel in train()")


@pytest.mark.parametrize("option", [None, "fused", "int8"])
def test_train_mode_takes_the_stock_conv(monkeypatch, option):
    """The kernels are forward-only (the JAX package has no VJP for them
    either): in train() every option takes the stock conv, equals the
    option-less module bit for bit and passes gradients to the weight."""
    monkeypatch.setattr(port_pc, "pos_conv_gelu", _refuse)
    monkeypatch.setattr(port_pc, "pos_conv_gelu_q8", _refuse)
    torch.manual_seed(0)
    ref = ConvPositionalEmbedding(128, 32, 4)
    mod = ConvPositionalEmbedding(128, 32, 4, option=option)
    mod.load_state_dict(ref.state_dict())
    x = torch.from_numpy(np.random.RandomState(44).randn(2, 53, 128).astype(np.float32))
    got = mod.train()(x)
    assert torch.equal(got, ref.train()(x))
    got.square().sum().backward()
    assert mod[0].weight.grad is not None and mod[0].bias.grad is not None


@pytest.mark.parametrize("name,cfg,kwargs,match", [
    ("hubert_large_ll60k", None, dict(fused_posconv=True, int8_posconv=True),
     "fused_posconv and int8_posconv"),
    ("wavlm_large", None, dict(fused_posconv=True, int8_posconv=True),
     "fused_posconv and int8_posconv"),
    ("hubert_large_ll60k", dict(conv_pos=16), dict(int8_posconv=True), "int8_posconv cannot"),
    ("hubert_large_ll60k", dict(conv_pos=24), dict(fused_posconv=True), "fused_posconv cannot"),
    ("wavlm_large", dict(conv_pos=48), dict(int8_posconv=True), "int8_posconv cannot"),
    ("wavlm_large", dict(conv_pos=25), dict(fused_posconv=True), "fused_posconv cannot"),
], ids=["both", "wavlm-both", "k16-int8", "k24-fused", "wavlm-k48-int8", "wavlm-odd-k"])
def test_posconv_keywords_refuse_what_cannot_take_effect(name, cfg, kwargs, match):
    """At load, before any weight is built: both keywords at once (the JAX
    switch has one value) and a conv_pos that fails the JAX gate (k even
    and a multiple of 16 for K16a, 32 for K16b)."""
    kwargs = {"dtype": torch.bfloat16, "flash": True, "quantize": True, **kwargs}
    if cfg is None:
        with pytest.raises(ValueError, match=match):
            hub.load(name, device="cpu", **kwargs)
        return
    model_cls, base = (WavLMModel, WAVLM) if name == "wavlm_large" else (Wav2Vec2Trunk, HUBERT)
    cfg_cls = WavLMConfig if name == "wavlm_large" else Wav2Vec2Config
    with pytest.raises(ValueError, match=match):
        model_cls(cfg_cls(**{**base, **cfg}), dtype=torch.bfloat16, use_flash=True,
                  quantize=True, device="meta", **{k: v for k, v in kwargs.items()
                                                   if k.endswith("posconv")})


@pytest.mark.parametrize("option,k,limit", [("fused", 528, port_pc.MAX_TAPS),
                                              ("int8", 1056, port_pc.MAX_TAPS_Q8)])
def test_posconv_option_over_the_card_tap_limit_refuses_at_load(monkeypatch, option, k, limit):
    """A pos-conv built for the card (a CUDA device) with a conv_pos that
    passes the JAX gate but exceeds the card kernel's tap limit raises at
    load, naming the limit, before anything touches CUDA; built on the CPU
    (the plain version takes any k) it is made."""
    monkeypatch.setattr(torch.cuda, "_lazy_init", lambda: pytest.fail("CUDA was touched"))
    for device in ("cuda", torch.device("cuda", 0)):
        with pytest.raises(ValueError, match=f"conv_pos up to {limit}, got {k}"):
            ConvPositionalEmbedding(1024, k, 16, option=option, device=device)
    mod = ConvPositionalEmbedding(1024, k, 16, option=option, device="cpu")
    assert mod[0].weight.shape == (1024, 64, k)


def test_posconv_k528_on_the_cpu_matches_jax():
    """The fused pos-conv with conv_pos = 528 (over K16a's card limit, inside
    the JAX gate) built on the CPU: eval mode runs K16a's plain version,
    which matches the JAX kernel (interpret mode) at HuBERT-Large's width."""
    x, kern, weight, bias = _conv_inputs(45, 37, B=1, C=1024, G=16, k=528)
    mod = ConvPositionalEmbedding(1024, 528, 16, option="fused", device="cpu").eval()
    mod.load_state_dict({"0.weight": weight, "0.bias": torch.from_numpy(bias)})
    with torch.no_grad():
        got = mod(torch.from_numpy(x))
    want = jax_pc.pos_conv_gelu(jnp.asarray(x), jnp.asarray(kern), jnp.asarray(bias), groups=16,
                                interpret=True)
    assert tuple(got.shape) == (1, 37, 1024)
    np.testing.assert_allclose(_np(got), _np(want), atol=2e-5, rtol=0)


@pytest.mark.parametrize("model", MODELS)
def test_options_keep_the_state_dict_and_build_their_weights(params, model):
    """The keywords are plain attributes, not state: the state_dict keeps
    ``encoder.pos_conv.0.{weight,bias}``. ``int8_posconv`` keeps the
    pos-conv weight in f32 (also in the bf16 model) and caches its codes and
    scales, ``fused_posconv`` keeps it in the model dtype and caches its
    tap-major GEMM weight; both are rebuilt by `load_state_dict`."""
    plain = _port(model, "int8", params[model]).model
    for option in OPTIONS:
        m = _port(model, "int8", params[model], **{option: True}).model
        assert m.state_dict().keys() == plain.state_dict().keys()
        pos = m.encoder.pos_conv
        w = pos[0].weight
        if option == "int8_posconv":
            assert pos.option == "int8" and w.dtype == torch.float32
            codes, scales = port_pc.quantize_posconv_weight(w, 4)
            assert torch.equal(pos.w_q8, codes) and torch.equal(pos.w_scale, scales)
        else:
            assert pos.option == "fused" and w.dtype == torch.bfloat16
            assert torch.equal(pos.gemm_weight, port_pc.posconv_gemm_weight(w, 4))
        torch.testing.assert_close(w.float(), plain.encoder.pos_conv[0].weight.float(),
                                   atol=0, rtol=2 ** -8)
        sd = m.state_dict()
        sd["encoder.pos_conv.0.weight"] = sd["encoder.pos_conv.0.weight"] * 2
        m.load_state_dict(sd)
        if option == "int8_posconv":
            assert torch.equal(pos.w_q8, port_pc.quantize_posconv_weight(pos[0].weight, 4)[0])
        else:
            assert torch.equal(pos.gemm_weight, port_pc.posconv_gemm_weight(pos[0].weight, 4))
