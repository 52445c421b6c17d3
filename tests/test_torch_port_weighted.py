"""SUPERB's fused weighted sum of s3prl_tpu_torch vs s3prl_tpu (CPU):
`TrunkUpstream.apply_weighted` and `TransformerEncoder.forward(...,
layer_weights)`.

Tiny trunks (four layers, C 128, H 2) of a pre-LN family (HuBERT-Large's
layer-norm extractor, the block rule) and a post-LN one (data2vec's, the
conv rule and the depth-5 pos-conv stack) are built by the JAX package's
own `_trunk_upstream` (random weights, every leaf perturbed) and carried
to the port with `trunk_state_dict_from_jax`. Tolerances: f32 at atol
5e-4 against JAX `apply_weighted` (the ROADMAP bar); bf16 bit-equal to
JAX's accumulation rule (``acc + w.astype(h.dtype) * h`` in a scan,
transformer.py:753-786) run on the port's own bf16 states, and at cosine
> 0.999 against JAX's bf16 `apply_weighted`; f32 at atol 2e-5 against the
softmax-weighted sum of the port's own `apply_standardized` states (the
bar of tests/test_models.py:140-153). A dispatch-mode spy shows that the
weighted forward makes no [L+1, B, T', C] (or [L, ...]) tensor and no host
round trip that the plain forward does not make.
"""

import numpy as np
import pytest
import torch
from torch.utils._python_dispatch import TorchDispatchMode

import jax
import jax.numpy as jnp

import s3prl_tpu.models.transformer as jax_transformer
import s3prl_tpu.upstream.registry as jax_registry
import s3prl_tpu_torch.models.transformer as port_transformer
from s3prl_tpu.models.wav2vec2 import Wav2Vec2Config as JaxConfig
from s3prl_tpu_torch.models.wav2vec2 import Wav2Vec2Config, Wav2Vec2Trunk
from s3prl_tpu_torch.upstream.base import TrunkUpstream
from s3prl_tpu_torch.upstream.convert import trunk_state_dict_from_jax
from test_torch_port_slice import _batch, _jax_defaults, _layer_cosines  # noqa: F401 (fixture)
from test_torch_port_w2v2 import CASES, WIDTH, perturbed

L = 4
CFG = {
    "pre-LN": dict(WIDTH, encoder_layers=L, extractor_mode="layer_norm", layer_norm_first=True,
                   normalize=True),
    "post-LN": dict(WIDTH, **{**CASES["data2vec"], "encoder_layers": L}),
}
LENS = [9600, 6401, 3000, 401]  # T' = 29 frames
# precision -> (JAX dtype, port dtype, flash, quantize)
PRECISION = {"f32": (jnp.float32, torch.float32, False, False),
             "bf16": (jnp.bfloat16, torch.bfloat16, False, False),
             "int8": (jnp.bfloat16, torch.bfloat16, True, True)}


def weights(seed=48):
    """Softmaxed layer weights [L+1], as SUPERB's featurizer hands them."""
    logits = np.random.RandomState(seed).randn(L + 1).astype(np.float32)
    return np.exp(logits) / np.exp(logits).sum()


class _JaxUps(dict):
    """case -> (precision -> the JAX trunk upstream, made when first asked
    for; the f32 one's params, every leaf perturbed)."""

    def __missing__(self, case):
        def make(precision):
            dtype, _, flash, quantize = PRECISION[precision]
            return jax_registry._trunk_upstream("tiny", JaxConfig(**CFG[case]), dtype=dtype,
                                                flash=flash, quantize=quantize)

        ups = _Lazy(make)
        self[case] = ups, perturbed(ups["f32"].params["params"])
        return self[case]


class _Lazy(dict):
    def __init__(self, make):
        super().__init__()
        self.make = make

    def __missing__(self, key):
        self[key] = self.make(key)
        return self[key]


@pytest.fixture(scope="module")
def jax_ups():
    return _JaxUps()


def port_up(case, params, precision="f32"):
    _, dtype, flash, quantize = PRECISION[precision]
    cfg = Wav2Vec2Config(**CFG[case])
    model = Wav2Vec2Trunk(cfg, dtype=dtype, use_flash=flash, quantize=quantize, device="meta")
    model.to_empty(device="cpu")
    model.load_state_dict(trunk_state_dict_from_jax(params, cfg))
    return TrunkUpstream(name="tiny", model=model.eval(), num_layers=L + 1, hidden_size=128,
                         downsample_rate=320)


def jax_weighted(up, params, w, wavs, lens):
    """The JAX upstream's `apply_weighted` with `params` (f32 or bf16)."""
    hs, fl = jax.jit(up.apply_weighted)({"params": params}, jnp.asarray(w), jnp.asarray(wavs),
                                        jnp.asarray(lens))
    return np.asarray(jnp.asarray(hs, jnp.float32)), np.asarray(fl)


@pytest.mark.parametrize("case", list(CFG))
def test_apply_weighted_f32_matches_jax(jax_ups, case):
    ups, params = jax_ups[case]
    wavs, lens = _batch(49, LENS)
    w = weights()
    want, want_lens = jax_weighted(ups["f32"], params, w, wavs, lens)
    got, got_lens = port_up(case, params).apply_weighted(torch.from_numpy(w),
                                                         torch.from_numpy(wavs),
                                                         torch.from_numpy(lens))
    np.testing.assert_array_equal(got_lens.numpy(), want_lens)
    assert tuple(got.shape) == want.shape == (1, 4, 29, 128)
    np.testing.assert_allclose(got.numpy(), want, atol=5e-4, rtol=0)


@pytest.mark.parametrize("case", list(CFG))
def test_apply_weighted_bf16_rounds_as_jax(jax_ups, case):
    """bf16: the port's weighted sum is bit-equal to JAX's scan of ``acc +
    w.astype(bf16) * h`` over the port's own per-layer states (XLA rounds
    the product to bf16 before the sum, as torch's ``acc += w * h``), and
    at cosine > 0.999 against JAX's bf16 `apply_weighted`."""
    ups, params = jax_ups[case]
    wavs, lens = _batch(50, LENS)
    w = weights(51)
    up = port_up(case, params, "bf16")
    args = (torch.from_numpy(wavs), torch.from_numpy(lens))
    got, got_lens = up.apply_weighted(torch.from_numpy(w), *args)
    with torch.inference_mode():
        hs, _ = up.model(*args)
    states = jnp.asarray(hs.float().numpy(), jnp.bfloat16)

    def body(acc, x):
        h, wi = x
        return acc + wi.astype(h.dtype) * h, None

    rule, _ = jax.jit(lambda s, ws: jax.lax.scan(body, jnp.zeros_like(s[0]), (s, ws)))(
        states, jnp.asarray(w))
    assert got.dtype == torch.bfloat16
    np.testing.assert_array_equal(got[0].float().numpy(), np.asarray(rule, np.float32))
    want, want_lens = jax_weighted(ups["bf16"], params, w, wavs, lens)
    np.testing.assert_array_equal(got_lens.numpy(), want_lens)
    coss = _layer_cosines(got.float().numpy(), want, got_lens.numpy())
    assert min(coss) > 0.999, coss


def test_apply_weighted_int8_kernels_match_jax(jax_ups, monkeypatch):
    """int8 serving on the kernel route (JAX K1 / K2 / K3-tanh in interpret
    mode, the port's wrappers): cosine > 0.999 against JAX's int8
    `apply_weighted`."""
    monkeypatch.setattr(jax_transformer, "_fused_block_available", lambda: True)
    monkeypatch.setattr(port_transformer, "_fused_block_available", lambda x: True)
    ups, params = jax_ups["pre-LN"]
    wavs, lens = _batch(52, LENS)
    w = weights(53)
    model = jax_registry.Wav2Vec2Trunk(JaxConfig(**CFG["pre-LN"]), dtype=jnp.bfloat16,
                                       use_flash=True, quantize=True)
    variables = jax_registry._materialize_qcache(model, {"params": params})
    want, want_lens = jax.jit(ups["int8"].apply_weighted)(variables, jnp.asarray(w),
                                                          jnp.asarray(wavs), jnp.asarray(lens))
    got, got_lens = port_up("pre-LN", params, "int8").apply_weighted(
        torch.from_numpy(w), torch.from_numpy(wavs), torch.from_numpy(lens))
    np.testing.assert_array_equal(got_lens.numpy(), np.asarray(want_lens))
    coss = _layer_cosines(got.float().numpy(), np.asarray(jnp.asarray(want, jnp.float32)),
                          got_lens.numpy())
    assert min(coss) > 0.999, coss


@pytest.mark.parametrize("case", list(CFG))
def test_apply_weighted_is_the_weighted_sum_of_the_states(jax_ups, case):
    """f32: the fused sum equals the softmax-weighted sum of the port's own
    `apply_standardized` states over the model's T' frames (atol 2e-5)."""
    _, params = jax_ups[case]
    up = port_up(case, params)
    wavs, lens = (torch.from_numpy(a) for a in _batch(54, LENS))
    w = weights(55)
    hs, _ = up.apply_standardized(wavs, lens)
    fused, feat_lens = up.apply_weighted(torch.from_numpy(w), wavs, lens)
    T = fused.shape[2]
    want = torch.einsum("l,lbth->bth", torch.from_numpy(w), hs[:, :, :T])
    torch.testing.assert_close(fused[0], want, atol=2e-5, rtol=0)
    assert feat_lens.tolist() == up.model(wavs, lens)[1].tolist()


class _Ops(TorchDispatchMode):
    """Records every op's name and the shapes of the tensors it returns."""

    def __init__(self):
        super().__init__()
        self.names, self.shapes = [], []

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        out = func(*args, **(kwargs or {}))
        self.names.append(func.__name__)
        for t in (out if isinstance(out, (tuple, list)) else (out,)):
            if isinstance(t, torch.Tensor):
                self.shapes.append(tuple(t.shape))
        return out


@pytest.mark.parametrize("case", list(CFG))
def test_apply_weighted_never_stacks_the_layers(jax_ups, case):
    """The weighted forward makes no tensor of [L+1, B, T', C] or [L, B, T',
    C] (the plain forward makes the first: the spy sees it), and reads no
    value back to the host (aten._local_scalar_dense, what .item() runs)
    more often than the plain forward."""
    _, params = jax_ups[case]
    up = port_up(case, params)
    wavs, lens = (torch.from_numpy(a) for a in _batch(56, LENS))
    w = torch.from_numpy(weights(57))
    stacks = {(L + 1, 4, 29, 128), (L, 4, 29, 128)}
    with _Ops() as plain:
        up.model(wavs, lens)
    with _Ops() as fused:
        out, _ = up.apply_weighted(w, wavs, lens)
    assert tuple(out.shape) == (1, 4, 29, 128)
    assert stacks & set(plain.shapes)
    assert not stacks & set(fused.shapes)
    host = "_local_scalar_dense.default"
    assert fused.names.count(host) <= plain.names.count(host)


def test_apply_weighted_checks_the_weights(jax_ups):
    _, params = jax_ups["pre-LN"]
    up = port_up("pre-LN", params)
    wavs, lens = (torch.from_numpy(a) for a in _batch(58, [3200]))
    with pytest.raises(ValueError, match=r"layer_weights: shape \(4,\), expected \(5,\)"):
        up.apply_weighted(torch.ones(L), wavs, lens)
