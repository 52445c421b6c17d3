"""The conv front end's options in s3prl_tpu_torch vs s3prl_tpu (CPU).

K15 `ln_gelu`, K14 `fused_conv_ln_gelu`, K13a `conv0_ln_gelu_q8` and K13b
`fused_int8_conv_ln_gelu`: the port's wrappers on CPU tensors (their plain
versions) against the JAX functions with their Pallas kernels in interpret
mode, on the same numpy inputs. Then the options that route through them,
the port's keywords against the JAX package's switches: the tiny
HuBERT-Large-style trunk of `test_torch_port_slice.py` with ``int8_conv``
(S3PRL_INT8_CONV=1), ``fused_conv`` (S3PRL_FUSED_CONV=1) and ``fused_midln``
(S3PRL_MIDLN=pallas), and the tiny WavLM of `test_torch_port_wavlm.py` with
the last two. Each model test sets the JAX switch, sends both packages'
encoders down their kernel routes (`_fused_block_available` -> True) and
proves with spies on the JAX kernel functions and on the port's plain
versions that both took the option's route. Last, the keywords' refusals
and the train-mode repair: in train() every layer, layer 0 included, takes
the stock path and matches the JAX extractor's ``train=True``.
Tolerances:
- bf16 outputs within one bf16 step of the JAX kernel's (the f32 sums run
  in another order, so a value near a rounding boundary can land one step
  apart), with an absolute floor of 1e-6 where GELU's output is near 0;
- f32 outputs: K15 at atol 1e-5 (a row pass), K14 at atol 1e-4 (a K = k C
  product summed in another order);
- int8: scales at rtol 1e-6; codes equal, except at most 0.1% one step
  apart (the f32 LN statistics are summed in another order, which can move
  a value across a .5 tie);
- the models: f32 per-layer hidden states at atol 5e-4 over valid frames,
  bf16 and int8 per-layer cosine > 0.999 (the bars of
  `test_torch_port_fuse.py`); lengths exactly equal;
- train-mode extractor features against JAX's at f32 atol 1e-5.
"""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

import s3prl_tpu.kernels.conv_frontend as jax_cf
import s3prl_tpu.kernels.ln_gelu as jax_lg
import s3prl_tpu.models.transformer as jax_transformer
import s3prl_tpu_torch.kernels.conv_frontend as port_cf
import s3prl_tpu_torch.kernels.ln_gelu as port_lg
import s3prl_tpu_torch.models.convfe as port_convfe
import s3prl_tpu_torch.models.transformer as port_transformer
import test_torch_port_slice as hubert_tests
import test_torch_port_wavlm as wavlm_tests
from s3prl_tpu.models.convfe import ConvFeatureExtractor as JaxExtractor
from s3prl_tpu.models.wav2vec2 import Wav2Vec2Trunk as JaxTrunk
from s3prl_tpu.models.wavlm import WavLMModel as JaxWavLM
from s3prl_tpu.ops.quant import quantize_cols as jax_quantize_cols
from s3prl_tpu.upstream.base import Upstream as JaxUpstream
from s3prl_tpu_torch import hub
from s3prl_tpu_torch.models.convfe import ConvFeatureExtractor
from s3prl_tpu_torch.models.wav2vec2 import Wav2Vec2Trunk
from s3prl_tpu_torch.models.wavlm import WavLMModel
from s3prl_tpu_torch.upstream.base import Upstream
from s3prl_tpu_torch.upstream.convert import trunk_state_dict_from_jax, wavlm_state_dict_from_jax
from test_torch_port_slice import _batch, _layer_cosines, _valid_frames
from test_torch_port_wavlm import _spy

KNOBS = ("S3PRL_INT8_CONV", "S3PRL_FUSED_CONV", "S3PRL_MIDLN", "S3PRL_CONV_IMPL", "S3PRL_GELU")
DTYPES = {"f32": (jnp.float32, torch.float32), "bf16": (jnp.bfloat16, torch.bfloat16)}
# path -> (JAX dtype, port dtype, flash, quantize)
PATHS = {"f32": (jnp.float32, torch.float32, False, False),
         "bf16": (jnp.bfloat16, torch.bfloat16, True, False),
         "int8": (jnp.bfloat16, torch.bfloat16, True, True)}
# option -> the JAX switch that selects it
SWITCH = {"int8_conv": ("S3PRL_INT8_CONV", "1"), "fused_conv": ("S3PRL_FUSED_CONV", "1"),
          "fused_midln": ("S3PRL_MIDLN", "pallas")}


@pytest.fixture(autouse=True)
def _knobs_off(monkeypatch):
    """Every test starts from the JAX package's defaults."""
    for name in KNOBS + hubert_tests.JAX_KNOBS:
        monkeypatch.delenv(name, raising=False)


def _np(x):
    return np.asarray(x.float() if isinstance(x, torch.Tensor) else jnp.asarray(x, jnp.float32),
                      np.float64)


def _within_one_bf16_step(got, want):
    got, want = _np(got), _np(want)
    step = np.exp2(np.floor(np.log2(np.maximum(np.abs(want), 2.0 ** -126))) - 7)
    err = np.abs(got - want)
    assert (err <= np.maximum(step, 1e-6)).all(), err.max()


def _codes_match(got, want):
    """Equal codes, except at most 0.1% one step apart."""
    d = np.abs(_np(got) - _np(want))
    assert d.max() <= 1 and (d > 0).mean() <= 1e-3, (d.max(), (d > 0).mean())


def _ln_params(rng, C):
    return ((1 + 0.1 * rng.randn(C)).astype(np.float32), (0.1 * rng.randn(C)).astype(np.float32))


def _refuse(*args, **kwargs):
    raise AssertionError("a front-end kernel on a path that must not take it")


# -- the kernels --------------------------------------------------------------------

@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("gelu_mode", ["erf", "tanh"])
def test_k15_plain_matches_interpreted_pallas(gelu_mode, dtype):
    """[3, 37, 128]: 111 rows, not a multiple of the Pallas kernel's 1024."""
    jdt, tdt = DTYPES[dtype]
    rng = np.random.RandomState(0)
    x = (rng.randn(3, 37, 128) * 2 + 0.3).astype(np.float32)
    g, b = _ln_params(rng, 128)
    want = jax_lg.ln_gelu(jnp.asarray(x, jdt), jnp.asarray(g), jnp.asarray(b), interpret=True,
                          gelu_mode=gelu_mode if gelu_mode == "tanh" else None)
    got = port_lg.ln_gelu(torch.from_numpy(x).to(tdt), torch.from_numpy(g), torch.from_numpy(b),
                          gelu_mode)
    assert got.dtype == tdt and tuple(got.shape) == (3, 37, 128)
    if dtype == "f32":
        np.testing.assert_allclose(_np(got), _np(want), atol=1e-5, rtol=0)
    else:
        _within_one_bf16_step(got, want)


def _conv_kernel(rng, k, C, Cout):
    """A JAX-layout conv kernel [k, C, Cout] and the port's nn.Conv1d
    weight [Cout, C, k] of the same values."""
    kern = (rng.randn(k, C, Cout) / np.sqrt(k * C)).astype(np.float32)
    return kern, torch.from_numpy(np.ascontiguousarray(kern.transpose(2, 1, 0)))


@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("k,T", [(3, 37), (3, 38), (2, 37), (2, 38)])
def test_k14_plain_matches_interpreted_pallas(k, T, dtype):
    """A stride-2 valid conv over odd and even T, as the nn.Conv1d weight and
    as the load-time GEMM weight (`conv_gemm_weight`)."""
    jdt, tdt = DTYPES[dtype]
    rng = np.random.RandomState(1)
    B, C = 2, 128
    x = rng.randn(B, T, C).astype(np.float32)
    kern, weight = _conv_kernel(rng, k, C, C)
    g, b = _ln_params(rng, C)
    want = jax_cf.fused_conv_ln_gelu(jnp.asarray(x, jdt), jnp.asarray(kern), jnp.asarray(g),
                                     jnp.asarray(b), interpret=True)
    xt, gt, bt = torch.from_numpy(x).to(tdt), torch.from_numpy(g), torch.from_numpy(b)
    for w in (weight.to(tdt), port_cf.conv_gemm_weight(weight.to(tdt))):
        got = port_cf.fused_conv_ln_gelu(xt, w, gt, bt)
        assert got.dtype == tdt and tuple(got.shape) == (B, (T - k) // 2 + 1, C)
        if dtype == "f32":
            np.testing.assert_allclose(_np(got), _np(want), atol=1e-4, rtol=0)
        else:
            _within_one_bf16_step(got, want)


@pytest.mark.parametrize("dtype", DTYPES)
def test_k13a_plain_matches_interpreted_pallas(dtype):
    """conv0 (k=10, s=5) + LN + erf GELU + row-quant over 3,207 samples
    (T' = 640, a ragged last frame)."""
    jdt, tdt = DTYPES[dtype]
    rng = np.random.RandomState(2)
    wavs = rng.randn(2, 3207).astype(np.float32)
    kern = (rng.randn(10, 1, 128) / np.sqrt(10)).astype(np.float32)
    g, b = _ln_params(rng, 128)
    want_q, want_s = jax_cf.conv0_ln_gelu_q8(jnp.asarray(wavs, jdt), jnp.asarray(kern, jdt),
                                             jnp.asarray(g), jnp.asarray(b), interpret=True)
    weight = torch.from_numpy(np.ascontiguousarray(kern.transpose(2, 1, 0))).to(tdt)
    got_q, got_s = port_cf.conv0_ln_gelu_q8(torch.from_numpy(wavs).to(tdt), weight,
                                            torch.from_numpy(g), torch.from_numpy(b))
    assert got_q.dtype == torch.int8 and tuple(got_q.shape) == (2, 640, 128)
    assert got_s.dtype == torch.float32 and tuple(got_s.shape) == (2, 640, 1)
    np.testing.assert_allclose(_np(got_s), _np(want_s), rtol=1e-6, atol=0)
    _codes_match(got_q, want_q)


# (k, T): T' = 18 and 19, then T' = 1, 64 and 65, on and beside the 64-row
# tiles of csrc/int8_conv.cu
K13B_SHAPES = [(3, 37), (2, 38), (3, 3), (2, 2), (3, 129), (2, 128), (3, 131), (2, 130)]


@pytest.mark.parametrize("emit_q8", [True, False], ids=["q8", "bf16-out"])
@pytest.mark.parametrize("k,T", K13B_SHAPES)
def test_k13b_plain_matches_interpreted_pallas(k, T, emit_q8):
    """Per-tap int8 conv over int8 rows with f32 row scales; the weight as
    the f32 nn.Conv1d weight (quantized per tap inside) and as the
    load-time (codes, scales) pair, which equals the JAX per-tap
    `quantize_cols` bit for bit."""
    rng = np.random.RandomState(3)
    B, C = 2, 128
    xq = rng.randint(-127, 128, (B, T, C)).astype(np.int8)
    xs = (0.01 + 0.05 * rng.rand(B, T, 1)).astype(np.float32)
    kern, weight = _conv_kernel(rng, k, C, C)
    g, b = _ln_params(rng, C)
    want_q, want_s = jax_cf.fused_int8_conv_ln_gelu(
        jnp.asarray(xq), jnp.asarray(xs), jnp.asarray(kern), jnp.asarray(g), jnp.asarray(b),
        emit_q8=emit_q8, interpret=True)
    taps = port_cf.quantize_conv_taps(weight)
    for t in range(k):
        q, s = jax_quantize_cols(jnp.asarray(kern[t]))
        np.testing.assert_array_equal(taps[0][t].numpy(), np.asarray(q).T)
        np.testing.assert_array_equal(taps[1][t].numpy(), np.asarray(s))
    for w in (weight, taps):
        got_q, got_s = port_cf.fused_int8_conv_ln_gelu(
            torch.from_numpy(xq), torch.from_numpy(xs), w, torch.from_numpy(g),
            torch.from_numpy(b), emit_q8=emit_q8)
        t_out = (T - k) // 2 + 1
        if emit_q8:
            assert got_q.dtype == torch.int8 and tuple(got_q.shape) == (B, t_out, C)
            np.testing.assert_allclose(_np(got_s), _np(want_s), rtol=1e-6, atol=0)
            _codes_match(got_q, want_q)
        else:
            assert got_s is None and want_s is None and got_q.dtype == torch.bfloat16
            _within_one_bf16_step(got_q, want_q)


@pytest.mark.parametrize("k,T", [(3, 131), (2, 130)])
def test_k13b_tap_sum_and_epilogue_helpers(k, T):
    """The plain helpers the card's test mode is held with: the f32 tap sum
    (`fused_int8_conv_taps_reference`) through `ln_gelu_f32` and
    `quantize_rows` (or one cast) is `fused_int8_conv_ln_gelu_reference` bit
    for bit; the tap sum is each tap's exact int32 product with row 2j + t's
    scale, summed in tap order; and the epilogue given the statistics
    (`ln_gelu_from_stats`), fed torch's own mean and 1 / sqrt(var + eps),
    is `ln_gelu_f32` bit for bit."""
    from s3prl_tpu_torch.kernels import _common
    from s3prl_tpu_torch.ops.quant import int_mm, quantize_rows

    rng = np.random.RandomState(4)
    B, C = 3, 128
    xq = torch.from_numpy(rng.randint(-127, 128, (B, T, C)).astype(np.int8))
    xs = torch.from_numpy((0.01 + 0.05 * rng.rand(B, T, 1)).astype(np.float32))
    _, weight = _conv_kernel(rng, k, C, C)
    g, b = (torch.from_numpy(a) for a in _ln_params(rng, C))
    taps = port_cf.quantize_conv_taps(weight)
    acc = port_cf.fused_int8_conv_taps_reference(xq, xs, taps)
    t_out = (T - k) // 2 + 1
    assert acc.dtype == torch.float32 and tuple(acc.shape) == (B, t_out, C)
    want = None
    for t in range(k):  # row (b, j) of tap t is x row 2j + t, its scale xs[b, 2j + t]
        rows = xq[:, t:t + 2 * t_out - 1:2].reshape(-1, C)
        tap = (int_mm(rows, taps[0][t]).float().view(B, t_out, C)
               * xs[:, t:t + 2 * t_out - 1:2] * taps[1][t])
        want = tap if want is None else want + tap
    assert torch.equal(acc, want)
    y = _common.ln_gelu_f32(acc, g, b)
    q, s = port_cf.fused_int8_conv_ln_gelu_reference(xq, xs, taps, g, b)
    q_ref, s_ref = quantize_rows(y)
    assert torch.equal(q, q_ref) and torch.equal(s, s_ref)
    out, none = port_cf.fused_int8_conv_ln_gelu_reference(xq, xs, taps, g, b, emit_q8=False)
    assert none is None and torch.equal(out, y.to(torch.bfloat16))
    flat = acc.reshape(-1, C)
    mean = flat.mean(-1, keepdim=True)
    rstd = 1.0 / torch.sqrt(((flat - mean) ** 2).mean(-1, keepdim=True) + _common.LN_EPS)
    stats = torch.cat([mean, rstd], dim=1)
    assert torch.equal(_common.ln_gelu_from_stats(flat, stats, g, b), y.reshape(-1, C))


# -- the options through the models -------------------------------------------------

def _perturbed(params):
    rng = np.random.RandomState(0)
    return jax.tree_util.tree_map(
        lambda a: np.asarray(a, np.float32) + 0.05 * rng.randn(*np.shape(a)).astype(np.float32),
        params)


@pytest.fixture(scope="module")
def hubert_params():
    init = jax.jit(lambda key, w, n: JaxTrunk(hubert_tests.JCFG).init(key, w, n,
                                                                      deterministic=True))
    return _perturbed(init(jax.random.key(0), jnp.zeros((1, 3200)), jnp.asarray([3200]))["params"])


@pytest.fixture(scope="module")
def wavlm_params():
    init = jax.jit(lambda key, w, n: JaxWavLM(wavlm_tests.JCFG).init(key, w, n,
                                                                     deterministic=True))
    return _perturbed(init(jax.random.key(0), jnp.zeros((1, 3200)), jnp.asarray([3200]))["params"])


MODELS = {  # name -> (JAX class, JAX config, port class, port config, state_dict converter)
    "hubert": (JaxTrunk, hubert_tests.JCFG, Wav2Vec2Trunk, hubert_tests.PCFG,
               trunk_state_dict_from_jax),
    "wavlm": (JaxWavLM, wavlm_tests.JCFG, WavLMModel, wavlm_tests.PCFG,
              wavlm_state_dict_from_jax),
}


def _run_jax(model, path, params, wavs, lens):
    """The JAX model jitted afresh: the S3PRL_* switches are read while it
    traces."""
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
    _, _, port_cls, cfg, convert = MODELS[model]
    _, dtype, flash, quantize = PATHS[path]
    m = port_cls(cfg, dtype=dtype, use_flash=flash, quantize=quantize, device="meta", **options)
    m.to_empty(device="cpu")
    m.load_state_dict(convert(params, cfg))  # builds the int8 and front-end caches
    return Upstream(name="tiny", model=m.eval(), num_layers=cfg.encoder_layers + 1,
                    hidden_size=cfg.encoder_embed_dim, downsample_rate=hubert_tests.STRIDE)


# (model, path, option) -> ({JAX kernel function: calls}, {port plain version: calls})
ROUTES = {
    ("hubert", "int8", "int8_conv"): (
        {(jax_cf, "conv0_ln_gelu_q8"): 1, (jax_cf, "fused_int8_conv_ln_gelu"): 2,
         (jax_cf, "conv0_ln_gelu"): 0},
        {(port_cf, "conv0_ln_gelu_q8_reference"): 1,
         (port_cf, "fused_int8_conv_ln_gelu_reference"): 2,
         (port_cf, "conv0_ln_gelu_reference"): 0}),
    **{("hubert", path, "fused_conv"): (
        {(jax_cf, "conv0_ln_gelu"): 1, (jax_cf, "fused_conv_ln_gelu"): 2,
         (jax_cf, "conv0_ln_gelu_q8"): 0},
        {(port_cf, "conv0_ln_gelu_reference"): 1, (port_cf, "fused_conv_ln_gelu_reference"): 2,
         (port_cf, "conv0_ln_gelu_q8_reference"): 0})
       for path in ("f32", "bf16", "int8")},
    **{(model, path, "fused_midln"): (
        {(jax_cf, "conv0_ln_gelu"): 1, (jax_lg, "ln_gelu"): 2, (jax_cf, "fused_conv_ln_gelu"): 0},
        {(port_cf, "conv0_ln_gelu_reference"): 1, (port_lg, "ln_gelu_reference"): 2,
         (port_cf, "fused_conv_ln_gelu_reference"): 0})
       for model, path in (("hubert", "f32"), ("hubert", "bf16"), ("hubert", "int8"),
                           ("wavlm", "int8"))},
    ("wavlm", "bf16", "fused_conv"): (
        {(jax_cf, "conv0_ln_gelu"): 1, (jax_cf, "fused_conv_ln_gelu"): 2},
        {(port_cf, "conv0_ln_gelu_reference"): 1, (port_cf, "fused_conv_ln_gelu_reference"): 2}),
}


@pytest.mark.parametrize("model,path,option", list(ROUTES),
                         ids=["-".join(key) for key in ROUTES])
def test_option_matches_jax(hubert_params, wavlm_params, monkeypatch, model, path, option):
    """The option's keyword against the JAX switch, through both packages'
    kernel routes; the spies prove the option's route on both sides. On
    the int8 path ``fused_conv`` moves the front end's GELU from tanh to
    erf (conv0 included) and ``fused_midln``'s K15 runs tanh."""
    params = hubert_params if model == "hubert" else wavlm_params
    monkeypatch.setenv(*SWITCH[option])
    monkeypatch.setattr(jax_transformer, "_fused_block_available", lambda: True)
    monkeypatch.setattr(port_transformer, "_fused_block_available", lambda x: True)
    jax_counts, port_counts = ROUTES[model, path, option]
    jax_calls = {key: _spy(monkeypatch, *key) for key in jax_counts}
    port_calls = {key: _spy(monkeypatch, *key) for key in port_counts}
    wavs, lens = _batch(31, [6400, 3001, 1] if model == "hubert" else wavlm_tests.LENS)
    want, want_lens = _run_jax(model, path, params, wavs, lens)
    up = _port(model, path, params, **{option: True})
    hs, h_lens = up.apply_standardized(torch.from_numpy(wavs), torch.from_numpy(lens))
    got, got_lens = hs.float().numpy(), h_lens.numpy()
    np.testing.assert_array_equal(got_lens, want_lens)
    assert got.shape == want.shape
    assert {key: len(c) for key, c in jax_calls.items()} == jax_counts
    assert {key: len(c) for key, c in port_calls.items()} == port_counts
    if path == "f32":
        for b, n in enumerate(_valid_frames(got_lens, got.shape[2])):
            np.testing.assert_allclose(got[:, b, :n], want[:, b, :n], atol=5e-4, rtol=0)
    else:
        coss = _layer_cosines(got, want, got_lens)
        assert min(coss) > 0.999, coss
    tanh = path == "int8" and model == "hubert"
    if option == "fused_conv":  # K3 (conv0_ln_gelu_reference's 7th argument) in erf mode
        (args, _), = port_calls[port_cf, "conv0_ln_gelu_reference"]
        assert args[6] == "erf"
    if option == "fused_midln":
        assert [a[3] for a, _ in port_calls[port_lg, "ln_gelu_reference"]] == \
            ["tanh" if tanh else "erf"] * 2
        (args, _), = port_calls[port_cf, "conv0_ln_gelu_reference"]
        assert args[6] == ("tanh" if tanh else "erf")


def test_options_are_plain_attributes_and_build_their_weights(hubert_params):
    """The keywords are plain attributes, not state: the state_dict keeps
    the fairseq keys. ``int8_conv`` keeps the mid convs in f32 and caches
    their per-tap codes, ``fused_conv`` their tap-major GEMM weights, both
    rebuilt by `load_state_dict`."""
    plain = _port("hubert", "int8", hubert_params)
    for option in ("int8_conv", "fused_conv", "fused_midln"):
        up = _port("hubert", "int8", hubert_params, **{option: True})
        fe = up.model.feature_extractor
        assert getattr(fe, option)
        assert up.model.state_dict().keys() == plain.model.state_dict().keys()
        for layer in fe.conv_layers[1:]:
            w = layer.conv.weight
            if option == "int8_conv":
                assert w.dtype == torch.float32
                codes, scales = port_cf.quantize_conv_taps(w)
                assert torch.equal(layer.taps_q8, codes) and torch.equal(layer.taps_scale, scales)
            elif option == "fused_conv":
                assert w.dtype == torch.bfloat16
                assert torch.equal(layer.gemm_weight, port_cf.conv_gemm_weight(w))
    fe = _port("hubert", "int8", hubert_params, int8_conv=True).model.feature_extractor
    layer = fe.conv_layers[1]
    sd = fe.state_dict()
    sd["conv_layers.1.0.weight"] = sd["conv_layers.1.0.weight"] * 2
    fe.load_state_dict(sd)
    assert torch.equal(layer.taps_q8, port_cf.quantize_conv_taps(layer.conv.weight)[0])


# -- the keywords ---------------------------------------------------------------------

@pytest.mark.parametrize("name,kwargs,match", [
    ("hubert_large_ll60k", dict(int8_conv=True, quantize=False), "int8_conv"),
    ("wavlm_large", dict(int8_conv=True), "int8_conv"),
    ("hubert_large_ll60k", dict(int8_conv=True, fused_conv=True), "int8_conv and fused_conv"),
    ("hubert_large_ll60k", dict(fused_midln=True, int8_conv=True), "fused_midln and int8_conv"),
    ("hubert_large_ll60k", dict(fused_midln=True, fused_conv=True), "fused_midln and fused_conv"),
    ("wavlm_large", dict(fused_midln=True, fused_conv=True), "fused_midln and fused_conv"),
], ids=["int8_conv-bf16", "int8_conv-on-wavlm", "int8_conv-fused_conv", "midln-int8_conv",
        "midln-fused_conv", "wavlm-midln-fused_conv"])
def test_frontend_keywords_refuse_what_cannot_take_effect(name, kwargs, match):
    """At load, before any weight is built (the full-size configurations)."""
    kwargs = {"dtype": torch.bfloat16, "flash": True, "quantize": True, **kwargs}
    with pytest.raises(ValueError, match=match):
        hub.load(name, device="cpu", **kwargs)


@pytest.mark.parametrize("layers", [((64, 10, 4), (64, 3, 2)), ((64, 10, 5), (64, 4, 2)),
                                    ((64, 10, 5), (64, 3, 3))],
                         ids=["k0-not-2s0", "mid-k4", "mid-stride3"])
@pytest.mark.parametrize("option", ["int8_conv", "fused_conv"])
def test_chain_options_refuse_layers_they_cannot_serve(layers, option):
    """The chains need k0 == 2 s0 and every mid layer a stride-2 conv with k
    in {2, 3} (the JAX `fuse0` and `chainable`, convfe.py:201-207)."""
    with pytest.raises(ValueError, match="cannot take effect"):
        ConvFeatureExtractor(layers, quantize=True, device="meta", **{option: True})


# -- train() mode: the stock path (the layer-0 repair) -------------------------------

@pytest.fixture(scope="module")
def extractor_params():
    """A JAX extractor of the tiny trunk's layers, initialised in train mode
    (its layer 0 then declares `_Im2ColConv`'s kernel, the same path)."""
    fe = JaxExtractor(hubert_tests.JCFG.conv_feature_layers, mode="layer_norm")
    params = fe.init(jax.random.key(1), jnp.zeros((1, 3200)), train=True)["params"]
    return _perturbed(params)


def _port_extractor(params, **options):
    """The port's extractor (f32) with `params`' weights."""
    fe = ConvFeatureExtractor(hubert_tests.JCFG.conv_feature_layers, **options)
    sd = {}
    for i in range(len(fe.conv_layers)):
        sd[f"conv_layers.{i}.0.weight"] = torch.from_numpy(
            np.ascontiguousarray(params[f"conv_{i}"]["kernel"].transpose(2, 1, 0)))
        sd[f"conv_layers.{i}.2.1.weight"] = torch.from_numpy(params[f"ln_{i}"]["scale"])
        sd[f"conv_layers.{i}.2.1.bias"] = torch.from_numpy(params[f"ln_{i}"]["bias"])
    fe.load_state_dict(sd)
    return fe


def test_train_mode_extractor_matches_jax_train(extractor_params, monkeypatch):
    """Layer 0 in train(): the stock conv, the f32 LN cast to the model
    dtype, erf GELU (never the forward-only K3), as the JAX `train=True`
    path (`_Im2ColConv`, convfe.py:296-300), at f32 atol 1e-5; gradients
    reach conv_0 and ln_0."""
    monkeypatch.setattr(port_convfe, "conv0_ln_gelu", _refuse)
    wavs = np.random.RandomState(32).randn(2, 3207).astype(np.float32)
    fe = JaxExtractor(hubert_tests.JCFG.conv_feature_layers, mode="layer_norm")
    want = np.asarray(fe.apply({"params": extractor_params}, jnp.asarray(wavs), train=True))
    port = _port_extractor(extractor_params).train()
    got = port(torch.from_numpy(wavs))
    np.testing.assert_allclose(got.detach().numpy(), want, atol=1e-5, rtol=0)
    got.square().sum().backward()
    first = port.conv_layers[0]
    assert first.conv.weight.grad is not None and first.norm.weight.grad is not None


@pytest.mark.parametrize("option", ["none", "int8_conv", "fused_conv", "fused_midln"])
def test_train_mode_takes_the_stock_path(extractor_params, monkeypatch, option):
    """Every front-end kernel is forward-only: in train() each option takes
    the stock path, layer 0 included, and equals the default extractor's
    train() output bit for bit."""
    for module, name in ((port_convfe, "conv0_ln_gelu"), (port_convfe, "conv0_ln_gelu_q8"),
                         (port_convfe, "fused_conv_ln_gelu"),
                         (port_convfe, "fused_int8_conv_ln_gelu"), (port_convfe, "ln_gelu")):
        monkeypatch.setattr(module, name, _refuse)
    options = {} if option == "none" else {option: True}
    wavs = torch.from_numpy(np.random.RandomState(33).randn(2, 3207).astype(np.float32))
    got = _port_extractor(extractor_params, quantize=True, **options).train()(wavs)
    want = _port_extractor(extractor_params).train()(wavs)
    assert torch.equal(got, want)
