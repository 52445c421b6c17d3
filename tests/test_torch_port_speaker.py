"""The speaker probes of s3prl_tpu_torch vs s3prl_tpu (CPU): the x-vector
TDNN stack, SuperbXvector (statistics pooling and SAP, train and eval),
the GE2E recipe's SAP head and the diarization LSTM head against flax
through `probe_state_dict_from_jax`; the AM-softmax, GE2E and PIT losses
against the JAX tasks; EER, minDCF and the diarization error on
hypothesis-drawn inputs.

The same numpy inputs and weights (flax's, every leaf perturbed) go through
both packages, at input 24, hidden 16, aggregation 20 and B=4 rows of full,
partial, 1 and 0 frames, dropout 0 (the packages' generators differ).
Tolerances: outputs and every parameter gradient at atol 1e-5 (f32 sums in
other orders over the 512-channel convs); the losses at rtol 1e-6; the
argmin permutation, the metrics and the DER equal (host numpy copied from
the JAX package). The diarization head's padded frames are left out (flax's
RNN carries on over them, the packed LSTM leaves zeros; the PIT mask drops
them). A VALID TDNN stack over fewer than 15 frames gives flax's empty time
axis, and the pooling's embeddings equal flax's there.
"""

import functools

import numpy as np
import pytest
import torch
from hypothesis import given, settings
from hypothesis import strategies as st

import jax
import jax.numpy as jnp

import s3prl_tpu.metric as jax_metric
import s3prl_tpu.nn.heads as jax_heads
import s3prl_tpu.nn.speaker as jax_speaker
import s3prl_tpu_torch.metric as port_metric
import s3prl_tpu_torch.nn.speaker as port_speaker
from s3prl_tpu.nn.upstream import UpstreamDownstreamModel as JaxModel
from s3prl_tpu.task.diarization import DiarizationPITTask as JaxPITTask
from s3prl_tpu.task.speaker_verification import Ge2eVerificationTask as JaxGe2eTask
from s3prl_tpu.task.speaker_verification import SpeakerVerificationTask as JaxSVTask
from s3prl_tpu.task.speaker_verification import amsoftmax_logits as jax_amsoftmax
from s3prl_tpu.task.speaker_verification import ge2e_loss as jax_ge2e_loss
from s3prl_tpu_torch.nn import UpstreamDownstreamModel, init_params
from s3prl_tpu_torch.task import (DiarizationPITTask, Ge2eVerificationTask,
                                  SpeakerVerificationTask, amsoftmax_logits, ge2e_loss)
from s3prl_tpu_torch.upstream.convert import probe_state_dict_from_jax
from test_torch_port_w2v2 import perturbed

L, B, T, C = 3, 4, 30, 24
LENS = np.asarray([30, 17, 1, 0], np.int32)  # full, partial, one frame, none
HIDDEN, AGG, OUT = 16, 20, 12
KEY = jax.random.key(0)  # the JAX tasks' dropout key (dropout 0)

HEADS = {  # name -> (flax head, port head at input width C)
    "xvector stats": (lambda: jax_speaker.SuperbXvector(OUT, HIDDEN, AGG),
                      lambda: port_speaker.SuperbXvector(C, OUT, HIDDEN, AGG)),
    "xvector SAP": (lambda: jax_speaker.SuperbXvector(OUT, HIDDEN, AGG,
                                                      pooling="SelfAttentivePooling"),
                    lambda: port_speaker.SuperbXvector(C, OUT, HIDDEN, AGG,
                                                       pooling="SelfAttentivePooling")),
    "SapSpeakerHead": (lambda: jax_speaker.SapSpeakerHead(HIDDEN),
                       lambda: port_speaker.SapSpeakerHead(C, HIDDEN)),
    "diarization 1 layer": (lambda: jax_speaker.SuperbDiarizationModel(2, HIDDEN, 1),
                            lambda: port_speaker.SuperbDiarizationModel(C, 2, HIDDEN, 1)),
    "diarization 3 layers": (lambda: jax_speaker.SuperbDiarizationModel(2, HIDDEN, 3),
                             lambda: port_speaker.SuperbDiarizationModel(C, 2, HIDDEN, 3)),
}


def _states(seed=0, t=T):
    return np.random.RandomState(seed).randn(L, B, t, C).astype(np.float32)


@functools.lru_cache(maxsize=None)
def _jax_pair(name):
    """flax's UpstreamDownstreamModel(head) and its perturbed params."""
    jax_model = JaxModel(HEADS[name][0](), L)
    init = jax.jit(lambda key, hs, lens: jax_model.init(key, hs, lens))
    return jax_model, perturbed(init(jax.random.key(0), jnp.asarray(_states()),
                                     jnp.asarray(LENS))["params"])


def _pair(name):
    jax_model, params = _jax_pair(name)
    port = UpstreamDownstreamModel(HEADS[name][1](), L)
    port.load_state_dict(probe_state_dict_from_jax(params))
    return jax_model, params, port


def _grad(p):
    """p's gradient, zeros where none reached it (affine2 in eval)."""
    return (torch.zeros_like(p) if p.grad is None else p.grad).numpy()


def _valid(lens, t=T):
    return np.arange(t)[None, :] < lens[:, None]


@pytest.mark.parametrize("train", [False, True], ids=["eval", "train"])
@pytest.mark.parametrize("name", list(HEADS))
def test_head_matches_flax(name, train):
    """Outputs (a frame head's valid frames) and lengths; then every
    parameter's gradient of sum(out * g) (g from a seed, zero on a frame
    head's padded frames) against jax.grad. SuperbXvector's train mode
    adds affine2 and its ReLU."""
    jax_model, params, port = _pair(name)
    hs, lens = _states(1), LENS
    frames = name.startswith("diarization")
    apply = jax.jit(lambda p, x: jax_model.apply({"params": p}, x, jnp.asarray(lens),
                                                 train=train))
    want = apply(params, jnp.asarray(hs))
    port.train(train)
    got = port(torch.from_numpy(hs), torch.from_numpy(lens))
    if frames:
        np.testing.assert_array_equal(got[1].numpy(), np.asarray(want[1]))
        want, got = want[0], got[0]
    assert got.dtype == torch.float32 and tuple(got.shape) == np.asarray(want).shape
    mask = _valid(lens)[..., None] if frames else np.ones((B, 1), bool)
    np.testing.assert_allclose(got.detach().numpy() * mask, np.asarray(want) * mask,
                               atol=1e-5, rtol=0)
    g = np.random.RandomState(2).randn(*got.shape).astype(np.float32) * mask

    def weighted(p):
        out = apply(p, jnp.asarray(hs))
        return jnp.sum((out[0] if frames else out) * g)

    want_grads = probe_state_dict_from_jax(jax.jit(jax.grad(weighted))(params))
    (got * torch.from_numpy(g)).sum().backward()
    named = dict(port.named_parameters())
    assert named.keys() == want_grads.keys()
    for k, p in named.items():
        if ".bias_ih_" in k:  # torch's second LSTM bias: held at zero
            assert p.grad is None and not p.requires_grad, k
            continue
        np.testing.assert_allclose(_grad(p), want_grads[k].numpy(), atol=1e-5, rtol=0,
                                   err_msg=k)


@pytest.mark.parametrize("t", [10, 14])
@pytest.mark.parametrize("name", ["xvector stats", "xvector SAP"])
def test_short_inputs_carry_flax_empty_time_axis(name, t):
    """Fewer than 15 frames: the VALID stack gives [B, 0, out] as flax
    does (F.conv1d alone raises), and the embeddings equal flax's (mean 0,
    std sqrt(1e-10) under statistics pooling); the convs' gradients are
    zero, as jax.grad's."""
    jax_model, params, port = _pair(name)
    hs, lens = _states(3, t), np.asarray([t, 5, 1, 0], np.int32)
    backbone = port.downstream.tdnns
    assert tuple(backbone(torch.zeros(B, t, HIDDEN)).shape) == (B, 0, AGG)
    apply = jax.jit(lambda p, x: jax_model.apply({"params": p}, x, jnp.asarray(lens),
                                                 train=True))
    want = apply(params, jnp.asarray(hs))
    port.train()
    got = port(torch.from_numpy(hs), torch.from_numpy(lens))
    np.testing.assert_allclose(got.detach().numpy(), np.asarray(want), atol=1e-5, rtol=0)
    got.sum().backward()
    want_grads = probe_state_dict_from_jax(jax.grad(lambda p: apply(p, jnp.asarray(hs)).sum())(
        params))
    for k, p in port.named_parameters():
        np.testing.assert_allclose(_grad(p), want_grads[k].numpy(), atol=1e-5, rtol=0,
                                   err_msg=k)
        if ".tdnn_" in k:
            assert not p.grad.any(), k


def test_tdnn_layers_and_init():
    """A lone TDNN (context 3, dilation 2) against flax; the convs keep
    flax's names and layout ([k, in, out] -> [out, in, k]) and flax's init
    (lecun-normal, fan_in = k * in; zero bias); batch_norm=True raises."""
    jax_tdnn = jax_speaker.TDNN(7, 3, 2)
    x = np.random.RandomState(4).randn(2, 9, 5).astype(np.float32)
    params = perturbed(jax_tdnn.init(jax.random.key(1), jnp.asarray(x))["params"])
    tdnn = port_speaker.TDNN(5, 7, 3, 2)
    sd = probe_state_dict_from_jax(params)
    assert sd.keys() == {"conv.weight", "conv.bias"}
    np.testing.assert_array_equal(sd["conv.weight"].numpy(),
                                  np.asarray(params["conv"]["kernel"]).transpose(2, 1, 0))
    tdnn.load_state_dict(sd)
    np.testing.assert_allclose(tdnn(torch.from_numpy(x)).detach().numpy(),
                               np.asarray(jax_tdnn.apply({"params": params}, jnp.asarray(x))),
                               atol=1e-6, rtol=0)
    model = port_speaker.SuperbXvector(256, 512, 512, 1500)
    init_params(model, torch.Generator().manual_seed(0))
    w = model.tdnns.tdnn_1.conv.weight.detach()
    assert tuple(w.shape) == (512, 512, 3) and not model.tdnns.tdnn_1.conv.bias.any()
    assert abs(float(w.std()) * np.sqrt(3 * 512) - 1) < 0.02
    assert model.affine1.in_features == 3000 and model.output_size == 512
    with pytest.raises(NotImplementedError, match="batch_stats"):
        port_speaker.SuperbXvector(24, batch_norm=True)


@pytest.mark.parametrize("layers", [1, 3])
def test_converter_maps_each_unidirectional_layer(layers):
    """SuperbDiarizationModel's cells OptimizedLSTMCell_{i} sit under the
    model with no proj_ layers: one a layer, each to its own lstm_{i}
    (the rule that read 3 directions at 3 layers); RNNEncoder's cells are
    still read by direction."""
    _, params = _jax_pair(f"diarization {layers} layer{'s' if layers > 1 else ''}")
    sd = probe_state_dict_from_jax(params)
    cells = params["downstream"]
    for i in range(layers):
        kernel = np.concatenate([np.asarray(cells[f"OptimizedLSTMCell_{i}"][f"i{g}"]["kernel"])
                                 for g in "ifgo"], 1)
        np.testing.assert_array_equal(sd[f"downstream.lstm_{i}.weight_ih_l0"].numpy(), kernel.T)
    assert not any("reverse" in k for k in sd)
    bi = JaxModel(jax_heads.RNNEncoder(5, hidden_size=8, num_layers=2, dropout=0.0,
                                       proj_size=8), L)
    bi_params = bi.init(jax.random.key(0), jnp.zeros((L, 2, 4, C)), jnp.asarray([4, 2]))
    keys = probe_state_dict_from_jax(bi_params).keys()
    assert {f"downstream.lstm_{i}.weight_hh_l0{s}" for i in (0, 1) for s in ("", "_reverse")} \
        <= keys


# -- the losses against the JAX tasks ----------------------------------------------


def test_amsoftmax_task_matches_jax():
    """amsoftmax_logits (both norms floored at 1e-8: a zero embedding row),
    the task's loss, predictions and am_weight's gradient against the JAX
    task; am_weight is a parameter of the module, drawn after it."""
    jax_model, params, port = _pair("xvector stats")
    rng = np.random.RandomState(5)
    params = {**params, "am_weight": rng.randn(OUT, 7).astype(np.float32)}
    embs, weight = rng.randn(4, OUT).astype(np.float32), params["am_weight"]
    embs[2] = 0.0
    labels = np.asarray([0, 3, 6, 2])
    want = jax_amsoftmax(jnp.asarray(embs), jnp.asarray(weight), jnp.asarray(labels))
    got = amsoftmax_logits(torch.from_numpy(embs), torch.from_numpy(weight),
                           torch.from_numpy(labels))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-6, atol=1e-6)
    jax_task, task = JaxSVTask(jax_model, 7), SpeakerVerificationTask(port, 7)
    task.module.load_state_dict(probe_state_dict_from_jax(params))
    hs, batch = _states(6), {"class_id": labels}
    (want_loss, want_cache), want_grads = jax.jit(jax.value_and_grad(
        lambda p: jax_task.loss_and_cache(p, jnp.asarray(hs), jnp.asarray(LENS), batch, KEY,
                                          True), has_aux=True))(params)
    loss, cache = task.loss_and_cache(torch.from_numpy(hs), torch.from_numpy(LENS), batch,
                                      None, True)
    np.testing.assert_allclose(float(loss.detach()), float(want_loss), rtol=1e-6)
    np.testing.assert_array_equal(cache["prediction"].numpy(), np.asarray(want_cache["prediction"]))
    loss.backward()
    np.testing.assert_allclose(port.am_weight.grad.numpy(), np.asarray(want_grads["am_weight"]),
                               atol=1e-5, rtol=0)
    assert "am_weight" in dict(port.named_parameters())
    task.init_params(torch.Generator().manual_seed(0))
    assert abs(float(port.am_weight.detach().std()) / 0.01 - 1) < 0.2


@pytest.mark.parametrize("w", [10.0, 1e-7], ids=["w 10", "w below 1e-6"])
def test_ge2e_task_matches_jax(w):
    """ge2e_loss (exclusive centroids for each speaker's own row) through
    the GE2E task on [N M] = [2 2] embeddings, the rows beyond N M unused:
    the loss and the gradients of ge2e_w, ge2e_b and the head; w below
    1e-6 is clamped (its gradient zero in both)."""
    jax_model, params, port = _pair("SapSpeakerHead")
    params = {**params, "ge2e_w": np.float32(w), "ge2e_b": np.float32(-4.5)}
    jax_task, task = JaxGe2eTask(jax_model, 2), Ge2eVerificationTask(port, 2)
    task.module.load_state_dict(probe_state_dict_from_jax(params))
    hs = _states(7)
    lens = np.asarray([30, 17, 9, 3], np.int32)
    (want, _), want_grads = jax.jit(jax.value_and_grad(
        lambda p: jax_task.loss_and_cache(p, jnp.asarray(hs), jnp.asarray(lens), {}, KEY, True),
        has_aux=True))(params)
    loss, _ = task.loss_and_cache(torch.from_numpy(hs), torch.from_numpy(lens), {}, None, True)
    np.testing.assert_allclose(float(loss.detach()), float(want), rtol=1e-6)
    loss.backward()
    want_sd = probe_state_dict_from_jax(want_grads)
    for k, p in port.named_parameters():
        np.testing.assert_allclose(_grad(p), want_sd[k].numpy(), atol=1e-5, rtol=0,
                                   err_msg=k)
    if w < 1e-6:
        assert port.ge2e_w.grad.item() == 0.0
    e = np.random.RandomState(8).randn(3, 4, 6).astype(np.float32)
    np.testing.assert_allclose(
        float(ge2e_loss(torch.from_numpy(e), torch.tensor(7.0), torch.tensor(-2.0))),
        float(jax_ge2e_loss(jnp.asarray(e), jnp.float32(7.0), jnp.float32(-2.0))), rtol=1e-6)
    task.init_params(torch.Generator().manual_seed(0))
    assert port.ge2e_w.item() == 10.0 and port.ge2e_b.item() == -5.0


def _pit_batch(seed):
    """Labels on a grid twice the states' (as SD's 160-sample labels),
    rows 1 and 3 with the speakers swapped."""
    rng = np.random.RandomState(seed)
    label = (rng.rand(B, 2 * T, 2) > 0.5).astype(np.int32)
    label[1] = label[0][:, ::-1]
    label[3, :, 0] = 1 - label[3, :, 1]
    return {"label": label, "label_len": np.asarray([60, 25, 40, 0], np.int32),
            "unique_name": [f"c{b}" for b in range(B)]}


def test_pit_task_matches_jax(tmp_path):
    """The PIT loss (labels cut to the states' T, the mask by min(out_lens,
    label_len)), its per-row argmin, the predictions on valid frames and
    every parameter's gradient against the JAX task, on the recipe's one
    LSTM layer; then both reductions' DER and loss, and the test-mode RTTM
    byte for byte."""
    jax_model, params, port = _pair("diarization 1 layer")
    hs = _states(9)
    batches = [_pit_batch(10), _pit_batch(11)]
    jax_task = JaxPITTask(jax_model, rttm_dir=tmp_path / "jax")
    task = DiarizationPITTask(port, rttm_dir=tmp_path / "port")
    records = {"jax": [], "port": []}
    for batch in batches:
        (want, cache), want_grads = jax.value_and_grad(
            lambda p: jax_task.loss_and_cache(p, jnp.asarray(hs), jnp.asarray(LENS), batch, KEY,
                                              True), has_aux=True)(params)
        loss, got = task.loss_and_cache(torch.from_numpy(hs), torch.from_numpy(LENS), batch,
                                        None, True)
        np.testing.assert_allclose(float(loss.detach()), float(want), rtol=1e-6)
        np.testing.assert_array_equal(got["best_perm"].numpy(), np.asarray(cache["best_perm"]))
        assert len(set(got["best_perm"].tolist())) == 2
        lens = got["prediction_len"].numpy()
        np.testing.assert_array_equal(lens, np.asarray(cache["prediction_len"]))
        valid = _valid(lens)[..., None]
        np.testing.assert_array_equal(got["prediction"].numpy() * valid,
                                      np.asarray(cache["prediction"]) * valid)
        loss.backward()
        want_sd = probe_state_dict_from_jax(want_grads)
        for k, p in port.named_parameters():
            if p.requires_grad:
                np.testing.assert_allclose(_grad(p), want_sd[k].numpy(), atol=1e-5,
                                           rtol=0, err_msg=k)
        port.zero_grad()
        records["jax"].append({k: np.asarray(v) for k, v in cache.items()}
                              | {"unique_name": batch["unique_name"]})
        records["port"].append({k: v.detach().numpy() for k, v in got.items()}
                               | {"unique_name": batch["unique_name"]})
    want = jax_task.reduction("test", records["jax"])
    got = task.reduction("test", records["port"])
    assert got["der"] == want["der"] and 0 < got["der"]
    np.testing.assert_allclose(got["loss"], want["loss"], rtol=1e-6)
    assert (tmp_path / "port" / "hyp.rttm").read_bytes() == \
        (tmp_path / "jax" / "hyp.rttm").read_bytes()


# -- the host metrics on hypothesis-drawn inputs ----------------------------------

# scores on a coarse grid, so that ties occur
_trials = st.lists(st.tuples(st.integers(0, 1), st.integers(-6, 6)), min_size=1, max_size=40)


@settings(max_examples=80, deadline=None, derandomize=True)
@given(_trials)
def test_eer_and_min_dcf_equal_jax(trials):
    labels = [lab for lab, _ in trials]
    scores = [s / 4 for _, s in trials]
    assert port_metric.compute_eer(labels, scores) == jax_metric.compute_eer(labels, scores)
    assert port_metric.compute_minDCF(labels, scores) == \
        jax_metric.compute_minDCF(labels, scores)
    assert port_metric.compute_minDCF(labels, scores, p_target=0.05, c_miss=2.0) == \
        jax_metric.compute_minDCF(labels, scores, p_target=0.05, c_miss=2.0)


_activity = st.lists(st.tuples(*[st.integers(0, 1)] * 4), min_size=1, max_size=30)


@settings(max_examples=80, deadline=None, derandomize=True)
@given(_activity, st.integers(0, 35))
def test_diarization_error_equals_jax(frames, length):
    from s3prl_tpu.metric.diarization import calc_diarization_error as jax_der
    from s3prl_tpu.metric.diarization import der_from_accumulators as jax_der_acc

    a = np.asarray(frames, np.int32)
    pred, label = a[:, :2], a[:, 2:]
    got = port_metric.calc_diarization_error(pred, label, length)
    assert got == jax_der(pred, label, length)
    assert port_metric.der_from_accumulators(got) == jax_der_acc(got)
