"""The CTC probe of s3prl_tpu_torch vs s3prl_tpu (CPU): RNNEncoder (cuDNN's
LSTM on packed sequences) against flax's through `probe_state_dict_from_jax`,
its init and its frozen ``bias_ih``, the CTC loss against optax, the CTC
tasks and the Trainer on them.

The same numpy inputs and weights go through both packages. Tolerances:
the encoder's valid frames and every parameter gradient of a masked loss
at atol 1e-5 (f32 sums in other orders; measured below 1e-6); flax's
padded frames are left out (its RNN carries on over them, the packed LSTM
leaves zeros; nothing downstream reads them). The CTC loss per row at rtol
1e-5 and its logit gradient at rtol 1e-5 / atol 1e-5 (gradients are at
most 1 in size; F.ctc_loss's analytic gradient and optax's autodiff round
apart by up to 4e-6), an infeasible row included: optax's value near 1e5
and its gradient. The Trainer on the CTC task: test_torch_port_asr_train.
"""

import functools

import numpy as np
import pytest
import torch
import torch.nn.functional as F

import jax
import jax.numpy as jnp
import optax

import s3prl_tpu.nn.heads as jax_heads
from s3prl_tpu.data.encoder import CharacterSlotTokenizer as JaxSlotTokenizer
from s3prl_tpu.data.encoder import CharacterTokenizer as JaxCharacterTokenizer
from s3prl_tpu.nn.upstream import UpstreamDownstreamModel as JaxModel
from s3prl_tpu.task.speech2text_ctc import SlotFillingCTCTask as JaxSlotTask
from s3prl_tpu.task.speech2text_ctc import Speech2TextCTCTask as JaxCTCTask
from s3prl_tpu_torch.data.collate import pad_collate
from s3prl_tpu_torch.data.encoder import CharacterSlotTokenizer, CharacterTokenizer
from s3prl_tpu_torch.nn import RNNEncoder, UpstreamDownstreamModel, init_params
from s3prl_tpu_torch.ops.ctc import ctc_loss, ctc_loss_reference
from s3prl_tpu_torch.task import SlotFillingCTCTask, Speech2TextCTCTask
from s3prl_tpu_torch.train import Optimizer
from s3prl_tpu_torch.upstream.convert import probe_state_dict_from_jax
from test_torch_port_w2v2 import perturbed

L, B, T, C = 3, 4, 9, 24
LENS = np.asarray([9, 5, 1, 0], np.int32)  # full, partial, one frame, none
V, HIDDEN = 11, 16


@functools.lru_cache(maxsize=None)
def _jax_pair(bidirectional, layers, vocab=V):
    """flax's UpstreamDownstreamModel(RNNEncoder) and its perturbed params."""
    jax_model = JaxModel(jax_heads.RNNEncoder(vocab, hidden_size=HIDDEN, num_layers=layers,
                                              bidirectional=bidirectional, dropout=0.0,
                                              proj_size=HIDDEN), L)
    init = jax.jit(lambda key, hs, lens: jax_model.init(key, hs, lens))
    return jax_model, perturbed(init(jax.random.key(0), jnp.zeros((L, B, T, C)),
                                     jnp.asarray(LENS))["params"])


def _pair(bidirectional=True, layers=2, dropout=0.0):
    """flax's UpstreamDownstreamModel(RNNEncoder) with perturbed params and
    the port's carrying them."""
    jax_model, params = _jax_pair(bidirectional, layers)
    port = UpstreamDownstreamModel(RNNEncoder(C, V, HIDDEN, layers, bidirectional, dropout,
                                              HIDDEN), L)
    port.load_state_dict(probe_state_dict_from_jax(params))
    return jax_model, params, port.eval()


def _states(seed=0):
    return np.random.RandomState(seed).randn(L, B, T, C).astype(np.float32)


@pytest.mark.parametrize("bidirectional,layers", [(True, 2), (False, 1)],
                         ids=["bidirectional-2-layers", "forward-1-layer"])
def test_rnn_encoder_matches_flax(bidirectional, layers):
    """Valid frames and lengths; then the gradient of every parameter of
    sum(logits * g) over valid frames (g from a seed) against jax.grad, the
    0-frame row included. bias_ih takes no gradient (flax has no such
    bias; its converted value is zero)."""
    jax_model, params, port = _pair(bidirectional, layers)
    hs = _states()
    apply = jax.jit(lambda p, x: jax_model.apply({"params": p}, x, jnp.asarray(LENS)))
    want, want_lens = apply(params, jnp.asarray(hs))
    got, got_lens = port(torch.from_numpy(hs), torch.from_numpy(LENS))
    np.testing.assert_array_equal(got_lens.numpy(), np.asarray(want_lens))
    assert got.dtype == torch.float32 and tuple(got.shape) == (B, T, V)
    valid = (np.arange(T)[None, :] < LENS[:, None])
    np.testing.assert_allclose(got.detach().numpy()[valid], np.asarray(want)[valid], atol=1e-5,
                               rtol=0)
    g = np.random.RandomState(1).randn(B, T, V).astype(np.float32) * valid[..., None]

    def masked(p):
        return jnp.sum(apply(p, jnp.asarray(hs))[0] * g)

    want_grads = probe_state_dict_from_jax(jax.jit(jax.grad(masked))(params))
    port.train()
    (port(torch.from_numpy(hs), torch.from_numpy(LENS))[0] * torch.from_numpy(g)).sum().backward()
    named = dict(port.named_parameters())
    assert named.keys() == want_grads.keys()
    for k, p in named.items():
        if ".bias_ih_" in k:
            assert p.grad is None and not p.requires_grad and not p.any(), k
            continue
        np.testing.assert_allclose(p.grad.numpy(), want_grads[k].numpy(), atol=1e-5, rtol=0,
                                   err_msg=k)


def test_rnn_encoder_handles_a_batch_of_one_frame_rows():
    """Every row 1 frame or none (the conv length rule's shortest
    utterances): the none rows give zeros, and the rest equal flax."""
    jax_model, params, port = _pair()
    lens = np.asarray([1, 0, 1, 0], np.int32)
    hs = _states(2)
    want, _ = jax.jit(lambda p, x: jax_model.apply({"params": p}, x, jnp.asarray(lens)))(
        params, jnp.asarray(hs))
    got, _ = port(torch.from_numpy(hs), torch.from_numpy(lens))
    np.testing.assert_allclose(got[lens > 0, :1].detach().numpy(),
                               np.asarray(want)[lens > 0, :1], atol=1e-5, rtol=0)


def test_bias_ih_is_held_at_zero_and_not_trained():
    """torch's second LSTM bias: zero after init_params and after Adam
    steps, no gradient, not among the optimizer's parameters."""
    port = UpstreamDownstreamModel(RNNEncoder(C, V, HIDDEN, 2, proj_size=HIDDEN), L)
    init_params(port, torch.Generator().manual_seed(0))
    opt = Optimizer(port.parameters(), name="Adam", lr=1e-2)
    bias_ih = [p for k, p in port.named_parameters() if ".bias_ih_" in k]
    assert len(bias_ih) == 4 and not any(p is q for p in bias_ih for q in opt.params)
    assert len(opt.params) == len(list(port.parameters())) - 4
    port.train()
    for step in range(2):
        out, _ = port(torch.from_numpy(_states(step)), torch.from_numpy(LENS))
        out.square().sum().backward()
        opt.step()
    assert all(p.grad is None and not p.any() for p in bias_ih)
    assert port.downstream.lstm_0.bias_hh_l0.any()


def test_lstm_init_is_flax():
    """init_params: lecun-normal input kernels (variance 1 / in), an
    orthogonal recurrent kernel for each gate's [H, H] (so W_hh^T W_hh =
    4 I, not I), zero biases; the same weights from one seed."""
    H, In = 64, 96
    model = RNNEncoder(In, V, H, 1, proj_size=H)
    init_params(model, torch.Generator().manual_seed(3))
    lstm = model.lstm_0
    for suffix in ("", "_reverse"):
        w_hh = getattr(lstm, f"weight_hh_l0{suffix}").detach().double()
        for g in range(4):
            block = w_hh[g * H:(g + 1) * H]
            np.testing.assert_allclose((block @ block.T).numpy(), np.eye(H), atol=1e-5)
        np.testing.assert_allclose((w_hh.T @ w_hh).numpy(), 4 * np.eye(H), atol=1e-5)
        w_ih = getattr(lstm, f"weight_ih_l0{suffix}").detach()
        assert abs(float(w_ih.std()) * np.sqrt(In) - 1) < 0.03
        assert not getattr(lstm, f"bias_ih_l0{suffix}").any()
        assert not getattr(lstm, f"bias_hh_l0{suffix}").any()
    again = RNNEncoder(In, V, H, 1, proj_size=H)
    init_params(again, torch.Generator().manual_seed(3))
    assert all(torch.equal(a, b) for a, b in zip(model.state_dict().values(),
                                                 again.state_dict().values()))


def test_rnn_encoder_dropout_draws_from_the_generator():
    port = UpstreamDownstreamModel(RNNEncoder(C, V, HIDDEN, 2, proj_size=HIDDEN, dropout=0.3),
                                   L).eval()
    init_params(port, torch.Generator().manual_seed(0))
    hs, lens = torch.from_numpy(_states()), torch.from_numpy(LENS)
    eval_out = port(hs, lens)[0]
    port.train()
    a = port(hs, lens, generator=torch.Generator().manual_seed(7))[0]
    b = port(hs, lens, generator=torch.Generator().manual_seed(7))[0]
    c = port(hs, lens, generator=torch.Generator().manual_seed(8))[0]
    assert torch.equal(a, b) and not torch.equal(a, c) and not torch.equal(a, eval_out)


# -- the CTC loss against optax -------------------------------------------------

# frames, labels: feasible (incl. repeats that need a blank between them and
# an empty transcript), infeasible (too few frames; repeats), no frame
CTC_ROWS = [(12, [3, 4, 5, 6, 3]), (9, [4, 4, 4]), (3, [3, 5, 6, 4, 3]), (0, [5, 6]),
            (5, [2, 2, 3]), (12, []), (2, [5, 5]), (0, [])]


def _ctc_case(seed, K=7):
    rng = np.random.RandomState(seed)
    Bc, Tc, N = len(CTC_ROWS), 12, 5
    logits = (rng.randn(Bc, Tc, K) * 2).astype(np.float32)
    lens = np.asarray([t for t, _ in CTC_ROWS])
    labels = np.zeros((Bc, N), np.int64)
    label_lens = np.asarray([len(y) for _, y in CTC_ROWS])
    for b, (_, y) in enumerate(CTC_ROWS):
        labels[b, :len(y)] = y
    return logits, lens, labels, label_lens


def _optax(logits, lens, labels, label_lens):
    logit_pad = (np.arange(logits.shape[1])[None] >= lens[:, None]).astype(np.float32)
    label_pad = (np.arange(labels.shape[1])[None] >= label_lens[:, None]).astype(np.float32)

    def f(x):
        return optax.ctc_loss(x, logit_pad, labels, label_pad, blank_id=0)

    return np.asarray(f(jnp.asarray(logits))), np.asarray(jax.grad(lambda x: f(x).sum())(
        jnp.asarray(logits)))


@pytest.mark.parametrize("route", ["ctc_loss", "reference"])
@pytest.mark.parametrize("seed", [0, 1])
def test_ctc_loss_matches_optax(seed, route):
    """Per row and with the logit gradient: `ctc_loss` (F.ctc_loss where a
    row is feasible, the plain recursion elsewhere) and the plain recursion
    alone on every row. optax scores the infeasible and 0-frame rows near
    1e5, F.ctc_loss inf."""
    logits, lens, labels, label_lens = _ctc_case(seed)
    want, want_grad = _optax(logits, lens, labels, label_lens)
    x = torch.tensor(logits, requires_grad=True)
    if route == "ctc_loss":
        got = ctc_loss(x, torch.from_numpy(lens), labels, label_lens)
    else:
        got = ctc_loss_reference(F.log_softmax(x, -1), torch.from_numpy(lens),
                                 torch.from_numpy(labels), torch.from_numpy(label_lens))
    got.sum().backward()
    np.testing.assert_allclose(got.detach().numpy(), want, rtol=1e-5)
    np.testing.assert_allclose(x.grad.numpy(), want_grad, rtol=1e-5, atol=1e-5)
    infeasible = [2, 3, 6]
    assert (want[infeasible] > 9e4).all() and (want[[0, 1, 4, 5, 7]] < 1e3).all()
    torch_loss = F.ctc_loss(F.log_softmax(torch.from_numpy(logits), -1).transpose(0, 1),
                            torch.from_numpy(labels), torch.from_numpy(lens),
                            torch.from_numpy(label_lens), reduction="none")
    assert torch.isinf(torch_loss[[2, 6]]).all()


# -- the CTC tasks --------------------------------------------------------------

TEXTS = ["ab ba", "cab", "a", "bb", "abc cab", "c"]


def _task_pair(kind):
    """(JAX task, its params, port task) over the same probe; vocab from
    TEXTS (characters, or characters and slots)."""
    if kind == "asr":
        tokenizers = JaxCharacterTokenizer.from_text(TEXTS), CharacterTokenizer.from_text(TEXTS)
    else:
        sents, iobs = ["ab ba", "cab c"], ["B-x I-x", "O B-y"]
        tokenizers = (JaxSlotTokenizer.from_text(sents, iobs),
                      CharacterSlotTokenizer.from_text(sents, iobs))
    vocab = tokenizers[0].vocab_size
    jax_model, params = _jax_pair(True, 1, vocab)
    port_model = UpstreamDownstreamModel(RNNEncoder(C, vocab, HIDDEN, 1, proj_size=HIDDEN,
                                                    dropout=0.0), L)
    port_model.load_state_dict(probe_state_dict_from_jax(params))
    if kind == "asr":
        return JaxCTCTask(jax_model, tokenizers[0]), params, \
            Speech2TextCTCTask(port_model, tokenizers[1])
    return JaxSlotTask(jax_model, tokenizers[0]), params, \
        SlotFillingCTCTask(port_model, tokenizers[1])


def _ctc_batch(tokenizer, seed, kind):
    """B rows of token ids (an empty one, one longer than its 1 frame) and
    their reference text, collated as the recipes collate."""
    rng = np.random.RandomState(seed)
    items = []
    for b in range(B):
        if kind == "asr":
            text = ["abc", "ab ba", "cab", ""][b]
            ids = tokenizer.encode(text)
        else:
            sent, iob = [("ab ba", "B-x I-x"), ("cab c", "O B-y"), ("ab", "B-y"), ("c", "O")][b]
            ids = tokenizer.encode_iob(sent, iob)
            text = tokenizer.decode(ids)
        items.append({"class_ids": np.asarray(ids, np.int32), "labels": text,
                      "unique_name": f"u{b}", "w": rng.randn(3).astype(np.float32)})
    batch = pad_collate(items)
    batch.pop("w"), batch.pop("w_len")
    return batch


@pytest.mark.parametrize("kind", ["asr", "sf"])
def test_ctc_tasks_match_jax(kind):
    """loss_and_cache in eval on the same states and batch (its infeasible
    and 0-frame rows cost about 1e5 in both), then each reduction over two
    such records: loss at rtol 1e-5, predictions on valid frames and the
    metrics equal."""
    jax_task, params, port_task = _task_pair(kind)
    records = {"jax": [], "port": []}
    for seed in (0, 1):
        hs = _states(seed)
        batch = _ctc_batch(port_task.tokenizer, seed, kind)
        want_loss, want = jax.jit(lambda p, x, ids, n: jax_task.loss_and_cache(
            p, x, jnp.asarray(LENS), {"class_ids": ids, "class_ids_len": n}, None, False))(
                params, jnp.asarray(hs), batch["class_ids"], batch["class_ids_len"])
        got_loss, got = port_task.loss_and_cache(torch.from_numpy(hs), torch.from_numpy(LENS),
                                                 batch, None, False)
        assert float(want_loss) > 1e4
        np.testing.assert_allclose(float(got_loss.detach()), float(want_loss), rtol=1e-5)
        np.testing.assert_array_equal(got["prediction_len"].numpy(), np.asarray(want["prediction_len"]))
        valid = np.arange(T)[None, :] < LENS[:, None]
        np.testing.assert_array_equal(got["prediction"].numpy()[valid],
                                      np.asarray(want["prediction"])[valid])
        for name, cache in (("jax", want), ("port", got)):
            record = {k: np.asarray(v) for k, v in cache.items()}
            record.update(labels=batch["labels"], unique_name=batch["unique_name"])
            records[name].append(record)
    want_logs = jax_task.reduction("valid", records["jax"])
    got_logs = port_task.reduction("valid", records["port"])
    assert got_logs.keys() == want_logs.keys()
    np.testing.assert_allclose(got_logs.pop("loss"), want_logs.pop("loss"), rtol=1e-5)
    assert got_logs == want_logs
    assert port_task.valid_metric == jax_task.valid_metric
    assert port_task.valid_higher_better == jax_task.valid_higher_better
