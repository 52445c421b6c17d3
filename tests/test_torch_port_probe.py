"""The packaged probe API of s3prl_tpu_torch vs s3prl_tpu (CPU): the
featurizer, the heads, SUpstream, the optimizer chain, checkpoints and the
corpus preparers.

The same numpy inputs and weights go through both packages: a head's flax
params (biases perturbed: flax starts them at zero) reach the port through
`probe_state_dict_from_jax`. Tolerances: f32 outputs and gradients at atol
2e-5; bf16 states within two bf16 steps of JAX's value or of 1, the
inputs' scale, whichever is larger (XLA fuses the normalize chain in f32
and rounds once, PyTorch rounds each op); the optimizer's parameters after every
update at rtol 1e-5 / atol 1e-7 against optax given the same gradients
(f32 rounding of the same arithmetic in another order); the corpus
preparers' CSVs byte for byte.
"""

import numpy as np
import pandas as pd
import pytest
import torch
import yaml

import jax
import jax.numpy as jnp

import s3prl_tpu.nn.heads as jax_heads
import s3prl_tpu.problem as jax_problem
import s3prl_tpu.upstream.registry as jax_registry
import s3prl_tpu_torch.nn.heads as port_heads
import s3prl_tpu_torch.problem as port_problem
import s3prl_tpu_torch.upstream.registry as port_registry
from s3prl_tpu.models.wav2vec2 import Wav2Vec2Config as JaxConfig
from s3prl_tpu.nn.upstream import Featurizer as JaxFeaturizer
from s3prl_tpu.nn.upstream import SUpstream as JaxSUpstream
from s3prl_tpu.nn.upstream import UpstreamDownstreamModel as JaxModel
from s3prl_tpu.train.optimizers import build_optimizer as jax_build_optimizer
from s3prl_tpu.train.optimizers import build_scheduler as jax_build_scheduler
from s3prl_tpu.util.pseudo_data import _write_wav
from s3prl_tpu_torch.models.wav2vec2 import Wav2Vec2Config, Wav2Vec2Trunk
from test_torch_port_audio import quantile_rule
from s3prl_tpu_torch.nn.upstream import Featurizer, SUpstream, UpstreamDownstreamModel
from s3prl_tpu_torch.train import checkpoint as ckpt
from s3prl_tpu_torch.train.optimizers import Optimizer, build_scheduler
from s3prl_tpu_torch.upstream.base import Upstream
from s3prl_tpu_torch.upstream.convert import (probe_state_dict_from_jax,
                                              trunk_state_dict_from_jax)
from test_torch_port_w2v2 import WIDTH, perturbed

DTYPES = {"f32": (jnp.float32, torch.float32), "bf16": (jnp.bfloat16, torch.bfloat16)}
L, B, T, H = 5, 3, 11, 16
LENS = np.asarray([11, 6, 1], np.int32)


def _states(seed, dtype, shape=(L, B, T, H)):
    """hs [L, B, T, H] from a numpy seed, in both packages' dtype."""
    a = np.random.RandomState(seed).randn(*shape).astype(np.float32)
    jd, td = DTYPES[dtype]
    return jnp.asarray(a, jd), torch.from_numpy(a).to(td)


def _np(x):
    if isinstance(x, torch.Tensor):
        return x.detach().float().numpy()
    return np.asarray(jnp.asarray(x, jnp.float32))


def _close(got, want, dtype):
    """f32 at atol 2e-5; bf16 within two bf16 steps of the JAX value or of
    1 (the unit-scale inputs), whichever is larger."""
    got, want = _np(got), _np(want)
    assert got.shape == want.shape
    if dtype == "f32":
        np.testing.assert_allclose(got, want, atol=2e-5, rtol=0)
    else:
        step = np.exp2(np.floor(np.log2(np.maximum(np.abs(want), 2.0 ** -126))) - 7)
        assert (np.abs(got - want) <= np.maximum(2 * step, 2.0 ** -6)).all(), \
            np.abs(got - want).max()


# -- the featurizer -------------------------------------------------------------

FEATURIZERS = {"all layers": {}, "layer_selections": {"layer_selections": (3, 0, 2)},
               "normalize": {"normalize": True}}


@pytest.mark.parametrize("dtype", list(DTYPES))
@pytest.mark.parametrize("case", list(FEATURIZERS))
def test_featurizer_matches_jax(case, dtype):
    """Output in the states' dtype and the weights' gradient (f32)."""
    kw = FEATURIZERS[case]
    jhs, ths = _states(0, dtype)
    n = len(kw.get("layer_selections", range(L)))
    w = np.random.RandomState(1).randn(n).astype(np.float32)
    jax_f = JaxFeaturizer(L, **kw)
    out, lens = jax_f.apply({"params": {"weights": jnp.asarray(w)}}, jhs, jnp.asarray(LENS))
    port_f = Featurizer(L, **kw)
    port_f.load_state_dict({"weights": torch.from_numpy(w)})
    got, got_lens = port_f(ths, torch.from_numpy(LENS))
    assert got.dtype == ths.dtype and tuple(got.shape) == (B, T, H)
    _close(got, out, dtype)
    np.testing.assert_array_equal(got_lens.numpy(), np.asarray(lens))
    # the weights' gradient of <out, g>, g from a seed
    g = np.random.RandomState(2).randn(B, T, H).astype(np.float32)
    want_grad = jax.grad(lambda v: jnp.sum(jax_f.apply({"params": {"weights": v}}, jhs,
                                                       jnp.asarray(LENS))[0].astype(jnp.float32)
                                           * g))(jnp.asarray(w))
    (got.float() * torch.from_numpy(g)).sum().backward()
    tol = 2e-5 if dtype == "f32" else 2e-2 * float(np.abs(np.asarray(want_grad)).max())
    np.testing.assert_allclose(port_f.weights.grad.numpy(), np.asarray(want_grad), atol=tol, rtol=0)


def test_featurizer_passes_one_layer_through():
    jhs, ths = _states(3, "f32", (1, B, T, H))
    variables = JaxFeaturizer(1).init(jax.random.key(0), jhs, jnp.asarray(LENS))
    assert not variables  # no weights
    port_f = Featurizer(1)
    assert port_f.weights is None and not list(port_f.parameters())
    got, _ = port_f(ths, torch.from_numpy(LENS))
    assert torch.equal(got, ths[0])
    with pytest.raises(ValueError, match="2 layers"):
        port_f(ths.expand(2, -1, -1, -1), torch.from_numpy(LENS))


# -- the heads ------------------------------------------------------------------

HEADS = {  # name -> (JAX head, port head at input width H)
    **{pool: (lambda p=pool: jax_heads.UtteranceLevel(4, (8,), p),
              lambda p=pool: port_heads.UtteranceLevel(H, 4, (8,), p))
       for pool in jax_heads.POOLINGS},
    "UtteranceLevel, no hidden": (lambda: jax_heads.UtteranceLevel(4, (), "MeanPooling"),
                                  lambda: port_heads.UtteranceLevel(H, 4, (), "MeanPooling")),
    "FrameLevel": (lambda: jax_heads.FrameLevel(4, (8, 6)),
                   lambda: port_heads.FrameLevel(H, 4, (8, 6))),
    "FrameLevelLinear": (lambda: jax_heads.FrameLevelLinear(4),
                         lambda: port_heads.FrameLevelLinear(H, 4)),
    "MeanPoolingLinear": (lambda: jax_heads.MeanPoolingLinear(4),
                          lambda: port_heads.MeanPoolingLinear(H, 4)),
    "FrameConcatLinear": (lambda: jax_heads.FrameConcatLinear(4, 5),
                          lambda: port_heads.FrameConcatLinear(H, 4, 5)),
    "ConvBankHead": (lambda: jax_heads.ConvBankHead(4, (3, 4, 5), 6, 8, 0.5),
                     lambda: port_heads.ConvBankHead(H, 4, (3, 4, 5), 6, 8, 0.5)),
}


def _probe_pair(name, seed=0, **featurizer):
    """The JAX probe's params (biases perturbed) and the port's probe
    carrying them."""
    make_jax, make_port = HEADS[name]
    jax_model = JaxModel(make_jax(), L, **featurizer)
    jhs, _ = _states(seed, "f32")
    params = jax_model.init(jax.random.key(seed), jhs, jnp.asarray(LENS))["params"]
    params = perturbed(params)
    port_model = UpstreamDownstreamModel(make_port(), L, **featurizer)
    port_model.load_state_dict(probe_state_dict_from_jax(params))
    return jax_model, params, port_model.eval()


@pytest.mark.parametrize("dtype", list(DTYPES))
@pytest.mark.parametrize("name", list(HEADS))
def test_head_matches_jax(name, dtype):
    """Each pooling and head behind the featurizer, in eval, f32 and bf16
    states: the heads compute in f32 (flax's promotion), a pooling on the
    featurizer's output in its dtype. FrameConcatLinear's shifts wrap
    around the utterance axis (jnp.roll); ConvBankHead pads 'SAME' with
    even and odd kernels."""
    jax_model, params, port_model = _probe_pair(name)
    jhs, ths = _states(4, dtype)
    want = jax_model.apply({"params": params}, jhs, jnp.asarray(LENS))
    got = port_model(ths, torch.from_numpy(LENS))
    if isinstance(want, tuple):
        np.testing.assert_array_equal(got[1].numpy(), np.asarray(want[1]))
        want, got = want[0], got[0]
    assert got.dtype == torch.float32 and np.asarray(want).dtype == np.float32
    np.testing.assert_allclose(_np(got), _np(want), atol=2e-5 if dtype == "f32" else 2e-3,
                               rtol=0 if dtype == "f32" else 1e-2)


def test_probe_state_dict_keys_and_init():
    """Every port parameter comes from the flax tree, in flax's layout; the
    port's own init follows flax's (truncated normal, variance 1 / fan_in;
    zero biases and featurizer weights), the same from one seed on any
    device."""
    _, params, port_model = _probe_pair("ConvBankHead")
    sd = probe_state_dict_from_jax(params)
    assert sd.keys() == port_model.state_dict().keys()
    k = np.asarray(params["downstream"]["cnn_1"]["kernel"])  # [k, in, out]
    np.testing.assert_array_equal(sd["downstream.cnn_1.weight"].numpy(), k.transpose(2, 1, 0))
    from s3prl_tpu_torch.nn.upstream import init_params

    fresh = UpstreamDownstreamModel(port_heads.UtteranceLevel(512, 4, (256,)), L)
    init_params(fresh, torch.Generator().manual_seed(5))
    w = fresh.downstream.hidden_0.weight.detach().numpy()
    std = np.sqrt(1.0 / 512)
    assert abs(w.std() / std - 1) < 0.02 and np.abs(w).max() <= 2 * std / 0.87962566103423978
    assert not fresh.downstream.hidden_0.bias.any() and not fresh.featurizer.weights.any()
    again = UpstreamDownstreamModel(port_heads.UtteranceLevel(512, 4, (256,)), L)
    init_params(again, torch.Generator().manual_seed(5))
    assert all(torch.equal(a, b) for a, b in zip(fresh.state_dict().values(),
                                                 again.state_dict().values()))


def test_conv_bank_dropout_draws_from_the_generator():
    _, _, port_model = _probe_pair("ConvBankHead")
    _, ths = _states(5, "f32")
    lens = torch.from_numpy(LENS)
    eval_out = port_model(ths, lens)[0]
    assert torch.equal(eval_out, port_model(ths, lens, generator=torch.Generator())[0])
    port_model.train()
    a = port_model(ths, lens, generator=torch.Generator().manual_seed(7))[0]
    b = port_model(ths, lens, generator=torch.Generator().manual_seed(7))[0]
    c = port_model(ths, lens, generator=torch.Generator().manual_seed(8))[0]
    assert torch.equal(a, b) and not torch.equal(a, c) and not torch.equal(a, eval_out)


# -- SUpstream ------------------------------------------------------------------

TINY = dict(WIDTH, extractor_mode="layer_norm", layer_norm_first=True, normalize=True)


@pytest.fixture(scope="module")
def tiny_pair():
    """One tiny trunk's JAX upstream (every leaf perturbed) and the port's
    upstream on the same weights (CPU)."""
    up = jax_registry._trunk_upstream("tiny", JaxConfig(**TINY))
    params = perturbed(up.params["params"])
    up.params = {"params": params}
    cfg = Wav2Vec2Config(**TINY)
    model = Wav2Vec2Trunk(cfg, device="meta")
    model.to_empty(device="cpu")
    model.load_state_dict(trunk_state_dict_from_jax(params, cfg))
    return up, Upstream("tiny", model.eval(), cfg.encoder_layers + 1, cfg.encoder_embed_dim,
                        cfg.downsample_rate)


def _wrap(cls, upstream, normalize):
    s = cls.__new__(cls)
    s.upstream, s.normalize = upstream, normalize
    return s


@pytest.mark.parametrize("normalize", [False, True])
def test_supstream_matches_jax(tiny_pair, normalize):
    """Frozen: no grad, not inference tensors (a probe's backward saves
    them), the model left in eval(); normalize: LN without affine."""
    jax_up, port_up = tiny_pair
    rng = np.random.RandomState(9)
    lens = np.asarray([9600, 5000, 320], np.int32)
    wavs = (rng.randn(3, 9600) * (np.arange(9600) < lens[:, None])).astype(np.float32)
    want, want_lens = _wrap(JaxSUpstream, jax_up, normalize)(jnp.asarray(wavs), jnp.asarray(lens))
    sup = _wrap(SUpstream, port_up, normalize)
    got, got_lens = sup(torch.from_numpy(wavs), torch.from_numpy(lens))
    assert not got.requires_grad and not got.is_inference() and not port_up.model.training
    np.testing.assert_array_equal(got_lens.numpy(), np.asarray(want_lens))
    np.testing.assert_allclose(_np(got), _np(want), atol=1e-3 if normalize else 5e-4, rtol=0)
    hs_list, lens_list = sup.as_list(got, got_lens)
    assert len(hs_list) == len(lens_list) == sup.num_layers == 3
    assert sup.hidden_sizes == [128] * 3 and sup.downsample_rates == [320] * 3


def test_supstream_loads_hub_entries(monkeypatch):
    """extra_conf holds hub.load's keywords (a dtype by name, as YAML gives
    it); the recipes' default "fbank" loads (on the CPU when asked: without
    CUDA its default device, the card, raises) and equals JAX's: one layer
    of 240 (80 mel bins, two orders of deltas, CMVN), stride 160, the
    features by `test_torch_port_audio`'s quantile rule."""
    monkeypatch.setattr(port_registry, "HUBERT_LARGE", Wav2Vec2Config(**TINY))
    sup = SUpstream("hubert_large_ll60k", extra_conf={"dtype": "bf16", "flash": True,
                                                      "quantize": True, "device": "cpu"})
    layer = sup.upstream.model.encoder.layers[0]
    assert layer.quantize and layer.dtype == torch.bfloat16 and sup.num_layers == 3
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="no CUDA device"):
            SUpstream("fbank")
    fbank = SUpstream("fbank", extra_conf={"device": "cpu"})
    assert fbank.num_layers == 1 and fbank.hidden_sizes == [240]
    assert fbank.downsample_rates == [160]
    rng = np.random.RandomState(9)
    lens = np.asarray([9600, 5000, 3200], np.int32)
    wavs = (rng.randn(3, 9600) * 0.1 * (np.arange(9600) < lens[:, None])).astype(np.float32)
    want, want_lens = JaxSUpstream("fbank")(jnp.asarray(wavs), jnp.asarray(lens))
    got, got_lens = fbank(torch.from_numpy(wavs), torch.from_numpy(lens))
    np.testing.assert_array_equal(got_lens.numpy(), np.asarray(want_lens))
    assert got.shape == want.shape == (1, 3, 60, 240) and got.dtype == torch.float32
    quantile_rule(got.numpy(), np.asarray(want), "fbank")


def test_upstream_train_mode(tiny_pair):
    """train=True: the model in train() on the stock paths under no_grad
    (the JAX trainer differentiates the probe only); a model whose JAX
    train mode raises (layerdrop: no "layerdrop" stream) raises."""
    _, port_up = tiny_pair
    wavs, lens = torch.randn(2, 3200), torch.tensor([3200, 2000])
    hs, _ = port_up(wavs, lens, train=True)
    assert not hs.requires_grad and port_up.model.training
    hs, _ = port_up(wavs, lens)
    assert not hs.requires_grad and not port_up.model.training
    cfg = Wav2Vec2Config(**dict(TINY, encoder_layerdrop=0.1))
    model = Wav2Vec2Trunk(cfg, device="meta")
    with pytest.raises(NotImplementedError, match='encoder_layerdrop=0.1.*"layerdrop"'):
        Upstream("d", model, 3, 128, 320)(wavs, lens, train=True)


# -- the optimizer chain against optax --------------------------------------------

SHAPES = ((3, 4), (5,))


def _grads(seed, n, scale):
    rng = np.random.RandomState(seed)
    return [[(rng.randn(*s) * scale).astype(np.float32) for s in SHAPES] for _ in range(n)]


def _run_both(grads, **kw):
    """optax (the JAX package's build_optimizer) and the port's Optimizer on
    the same parameters and gradient sequence: the parameters after each
    call, and the port's optimizer."""
    rng = np.random.RandomState(0)
    init = [rng.randn(*s).astype(np.float32) for s in SHAPES]
    tx = jax_build_optimizer(**kw)
    params = {str(i): jnp.asarray(a) for i, a in enumerate(init)}
    state = tx.init(params)
    update = jax.jit(tx.update)
    port_params = [torch.nn.Parameter(torch.from_numpy(a.copy())) for a in init]
    opt = Optimizer(port_params, **kw)
    want, got = [], []
    for g in grads:
        updates, state = update({str(i): jnp.asarray(a) for i, a in enumerate(g)}, state,
                                   params)
        params = jax.tree_util.tree_map(lambda p, u: p + u, params, updates)
        want.append([np.asarray(params[str(i)]) for i in range(len(SHAPES))])
        for p, a in zip(port_params, g):
            p.grad = torch.from_numpy(a.copy())
        opt.step()
        got.append([p.detach().numpy().copy() for p in port_params])
    return want, got, opt, state


def _assert_same(want, got):
    for w_step, g_step in zip(want, got):
        for w, g in zip(w_step, g_step):
            np.testing.assert_allclose(g, w, rtol=1e-5, atol=1e-7)


OPTIMIZERS = {
    "Adam": dict(name="Adam", lr=1e-2),
    "AdamW": dict(name="AdamW", lr=1e-2, weight_decay=0.1),
    "SGD": dict(name="SGD", lr=1e-1),
    "linear_schedule": dict(name="Adam", lr=1e-2, scheduler="linear_schedule", total_steps=10,
                            warmup_proportion=0.2),
}


@pytest.mark.parametrize("scale", [0.1, 10.0], ids=["below-clip", "clipped"])
@pytest.mark.parametrize("case", list(OPTIMIZERS))
def test_optimizer_matches_optax(case, scale):
    """Global norm ~0.5 (no clip) or ~50 (clipped to 1.0)."""
    want, got, _, _ = _run_both(_grads(1, 12, scale), **OPTIMIZERS[case])
    _assert_same(want, got)


def test_linear_schedule_matches_optax():
    """lr of update i = optax's schedule(i): the first warm-up update 0."""
    port = build_scheduler("linear_schedule", 1e-3, 100, 0.07)
    jax_s = jax_build_scheduler("linear_schedule", 1e-3, 100, 0.07)
    lrs = [port(i) for i in range(110)]
    np.testing.assert_allclose(lrs, [float(jax_s(i)) for i in range(110)], rtol=1e-6,
                               atol=1e-12)
    assert lrs[0] == 0.0 and lrs[7] == pytest.approx(1e-3) and lrs[100] == 0.0
    assert build_scheduler(None, 1e-3, 100)(5) == 1e-3


def test_nan_gradient_is_skipped():
    """A step with a NaN changes neither the parameters nor the moments or
    the step count (Adam's bias correction); the next finite one goes on."""
    grads = _grads(2, 6, 1.0)
    grads[2][1][3] = np.nan
    want, got, opt, state = _run_both(grads, name="Adam", lr=1e-2)
    _assert_same(want, got)
    for a, b in zip(got[1], got[2]):
        np.testing.assert_array_equal(a, b)
    assert opt.count == 5 and opt.notfinite_count == 0
    adam = state.inner_state[1][0]  # apply_if_finite > chain(clip, adam) > scale_by_adam
    assert int(adam.count) == 5
    for i, p in enumerate(opt.params):
        np.testing.assert_allclose(opt.core.state[p]["exp_avg"].numpy(),
                                   np.asarray(adam.mu[str(i)]), rtol=1e-5, atol=1e-8)


def test_nan_gradients_applied_after_max_consecutive_errors():
    """After more than 100 non-finite updates in a row the update goes
    through (optax.apply_if_finite(..., 100))."""
    grads = _grads(3, 103, 1.0)
    for g in grads[1:]:
        g[0][0, 0] = np.inf
    want, got, opt, _ = _run_both(grads, name="SGD", lr=1e-1)
    for step in (100, 101, 102):  # calls 2-101 are skipped; 102 (> 100 in a row) applies
        np.testing.assert_array_equal(np.isnan(got[step][0]), np.isnan(want[step][0]))
    np.testing.assert_array_equal(got[100][1], got[0][1])
    assert not np.isfinite(got[101][0]).all() and opt.count == 3


@pytest.mark.parametrize("case", ["Adam", "linear_schedule"])
def test_gradient_accumulation_matches_optax(case):
    """gradient_accumulate=2: the mean of two micro-gradients, applied once;
    the parameters stay put on the first of each pair."""
    want, got, opt, _ = _run_both(_grads(4, 8, 1.0), gradient_accumulate=2, **OPTIMIZERS[case])
    _assert_same(want, got)
    for i in (0, 2, 4, 6):
        assert np.array_equal(got[i][0], got[0][0] if i == 0 else got[i - 1][0])
    assert opt.count == 4


def test_optimizer_state_round_trip():
    """An optimizer rebuilt from a state dict mid-accumulation continues as
    the original does."""
    grads = _grads(5, 5, 1.0)
    _, got, opt, _ = _run_both(grads, name="Adam", lr=1e-2, gradient_accumulate=2)
    params = [torch.nn.Parameter(torch.from_numpy(a)) for a in got[2]]
    twin = Optimizer(params, name="Adam", lr=1e-2, gradient_accumulate=2)
    _, part, opt3, _ = _run_both(grads[:3], name="Adam", lr=1e-2, gradient_accumulate=2)
    twin.load_state_dict(opt3.state_dict())
    for g in grads[3:]:
        for p, a in zip(params, g):
            p.grad = torch.from_numpy(a.copy())
        twin.step()
    for p, a in zip(params, got[-1]):
        np.testing.assert_array_equal(p.detach().numpy(), a)


def test_optimizer_refuses_unknown_names():
    with pytest.raises(ValueError, match="unknown optimizer"):
        Optimizer([torch.nn.Parameter(torch.zeros(1))], name="Lion")
    with pytest.raises(ValueError, match="unknown scheduler"):
        build_scheduler("cosine", 1e-3, 10)


# -- checkpoints ----------------------------------------------------------------


def _save(d, step, keep=2):
    return ckpt.save_checkpoint(d, step, {"w": torch.full((3,), float(step))},
                                {"count": step}, stats={"best_metric": 0.5},
                                keep_num_ckpts=keep)


def test_checkpoint_atomicity_and_gc(tmp_path):
    """Step dirs are written through step_<N>.tmp and a marker holding each
    payload's size; an interrupted write, a missing marker or a truncated
    payload is never resumed from; keep_num_ckpts GCs the oldest."""
    for step in (1, 2, 3):
        _save(tmp_path, step)
    assert sorted(p.name for p in tmp_path.iterdir()) == ["step_2", "step_3"]
    marker = yaml.safe_load((tmp_path / "step_3" / ckpt.COMPLETE_MARKER).read_text())
    assert set(marker) == {"model.pt", "optimizer.pt", "training_stats.yaml"}
    model_state, opt_state, stats = ckpt.load_checkpoint(ckpt.latest_checkpoint(tmp_path))
    assert torch.equal(model_state["w"], torch.full((3,), 3.0))
    assert opt_state == {"count": 3} and stats == {"step": 3, "best_metric": 0.5}
    (tmp_path / "step_9.tmp").mkdir()  # an interrupted write
    (tmp_path / "step_8").mkdir()  # no marker
    _save(tmp_path, 7, keep=None)
    with open(tmp_path / "step_7" / "model.pt", "r+b") as f:  # truncated after the write
        f.truncate(10)
    assert ckpt.latest_checkpoint(tmp_path).name == "step_3"
    ckpt.mark_valid_best(tmp_path, 3)
    assert ckpt.load_checkpoint(tmp_path / "valid_best")[2]["step"] == 3
    _save(tmp_path, 3)  # a re-save of the same step replaces it
    assert ckpt.latest_checkpoint(tmp_path).name == "step_3"


# -- the corpus preparers (stage 0) --------------------------------------------------


def _wav(path, secs=0.5, seed=0):
    path.parent.mkdir(parents=True, exist_ok=True)
    _write_wav(path, np.random.RandomState(seed).randn(int(16000 * secs)) * 0.1)


def voxceleb1_layout(root):
    lines = []
    for s, spk in enumerate(("id10001", "id10002", "id10003")):
        for u in range(4):
            rel = f"{spk}/vid{u % 2}/{u:05d}.wav"
            _wav(root / "wav" / rel, 0.3 + 0.05 * u, seed=10 * s + u)
            lines.append(f"{1 if u < 2 else 2 if u == 2 else 3} {rel}")
    (root / "iden_split.txt").write_text("\n".join(lines) + "\n")
    return {"voxceleb1": str(root)}


def speech_commands_layout(root):
    for word in ("yes", "no", "bed", "_background_noise_"):
        for u in range(3 if word != "_background_noise_" else 1):
            _wav(root / word / f"{u:08x}_nohash_0.wav", 3.2 if word[0] == "_" else 0.2)
    (root / "validation_list.txt").write_text("yes/00000001_nohash_0.wav\nbed/00000000_nohash_0.wav\n")
    (root / "testing_list.txt").write_text("no/00000002_nohash_0.wav\n")
    return {"speech_commands": str(root)}


def iemocap_layout(root):
    for i in range(1, 6):
        emo = root / f"Session{i}" / "dialog" / "EmoEvaluation"
        emo.mkdir(parents=True)
        rows = [f"[6.2 - 8.2]\tSes0{i}F_impro01_F00{j}\t{e}\t[2.5, 2.5, 2.5]"
                for j, e in enumerate(("neu", "exc", "ang", "sad", "fru", "hap"))]
        (emo / f"Ses0{i}F_impro01.txt").write_text("% header\n" + "\n".join(rows) + "\n")
    return {"iemocap": str(root), "test_fold": 2}


def fluent_layout(root):
    (root / "data").mkdir(parents=True)
    for split in ("train", "valid", "test"):
        pd.DataFrame({"path": [f"wavs/speakers/s{i}/{split}{i}.wav" for i in range(3)],
                      "speakerId": ["s0", "s1", "s2"], "transcription": ["a", "b", "c"],
                      "action": ["activate", "deactivate", "increase"],
                      "object": ["lights", "music", "heat"],
                      "location": ["kitchen", "none", "bedroom"]}).to_csv(
            root / "data" / f"{split}_data.csv")
    return {"fluent_speech_commands": str(root)}


CORPORA = {"SuperbSID": voxceleb1_layout, "SuperbKS": speech_commands_layout,
           "SuperbER": iemocap_layout, "SuperbIC": fluent_layout}


@pytest.mark.parametrize("recipe", list(CORPORA))
def test_stage0_writes_the_jax_csvs(tmp_path, recipe):
    """Each recipe's stage 0 on a tiny fake corpus laid out as its preparer
    reads it: the port writes the JAX package's CSVs byte for byte."""
    prepare = CORPORA[recipe](tmp_path / "corpus")
    for name, pkg in (("jax", jax_problem), ("port", port_problem)):
        getattr(pkg, recipe)().run(str(tmp_path / name), start=0, stop=0, prepare_data=prepare)
    csvs = sorted(p.name for p in (tmp_path / "jax").glob("*.csv"))
    assert csvs == sorted(p.name for p in (tmp_path / "port").glob("*.csv")) != []
    for name in csvs:
        want = (tmp_path / "jax" / name).read_bytes()
        assert (tmp_path / "port" / name).read_bytes() == want and len(want.splitlines()) > 1


def test_loader_ends_its_producer_when_the_consumer_stops(monkeypatch):
    """The prefetch thread ends when iteration stops early (the trainer
    leaves its loader at total_steps; the evaluation stage reads one
    batch); under a torch.distributed group of several processes the loader
    deals its rank every world-th batch (the JAX loader's
    `_maybe_distribute`), and ``distribute=False`` keeps them all."""
    import threading

    from s3prl_tpu_torch.data.loader import DataLoader
    from s3prl_tpu_torch.data.sampler import FixedBatchSizeBatchSampler

    data = [{"x": np.ones(i + 1, np.float32)} for i in range(40)]
    before = threading.active_count()
    loader = DataLoader(data, FixedBatchSizeBatchSampler(40, 2), prefetch=2)
    it = iter(loader)
    first = next(it)
    assert first["x"].shape == (2, 2) and first["x_len"].tolist() == [1, 2]
    it.close()
    assert threading.active_count() == before
    assert len(list(loader)) == 20 and threading.active_count() == before
    import torch.distributed as dist

    monkeypatch.setattr(dist, "is_initialized", lambda: True)
    monkeypatch.setattr(dist, "get_world_size", lambda: 4)
    monkeypatch.setattr(dist, "get_rank", lambda: 0)
    dealt = DataLoader(data, FixedBatchSizeBatchSampler(40, 2), prefetch=2)
    assert [b["x_len"].tolist() for b in dealt] == [[2 * i + 1, 2 * i + 2] for i in range(0, 20, 4)]
    assert threading.active_count() == before
    assert len(DataLoader(data, FixedBatchSizeBatchSampler(40, 2), distribute=False)) == 20
