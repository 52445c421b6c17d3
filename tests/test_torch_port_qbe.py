"""Query-by-example in s3prl_tpu_torch vs s3prl_tpu (CPU): the DTW scorer
(`ops/dtw`) against the JAX function and `tests/test_dtw.py`'s numpy DP,
the QbE embedder and its pair task against flax through
`probe_state_dict_from_jax`, QbeExample and QbeEmbeddingExample through
`Problem.run`, the QUESST 2014 preparer's pairs, and the five recipes'
default configs.

Tolerances: DTW scores at rtol 1e-5 (against both references; the port
sums each row's costs in float64, JAX in f32 by an associative scan),
documents in one chunk or in many; the embedder's output and every
gradient at atol 1e-5, the loss at rtol 1e-5; the recipes by the rules of
`test_torch_port_frame_probe` (the attention pooling's score bias
``attention_linear.bias`` is a shift: its gradient is zero but for
rounding). The embedder's rows have at least one frame: on a row of none,
flax's pooling averages the states its RNN carried over the padding, the
packed LSTM's padding is zeros.
"""

import functools

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

import s3prl_tpu.problem as jax_problem
import s3prl_tpu.problem.qbe as jax_qbe
import s3prl_tpu_torch.problem as port_problem
from s3prl_tpu.ops import dtw as jax_dtw
from s3prl_tpu.task.qbe_embedding import QbeEmbedder as JaxEmbedder
from s3prl_tpu.task.qbe_embedding import QbeEmbeddingTask as JaxTask
from s3prl_tpu.util.pseudo_data import _write_wav
from s3prl_tpu_torch.nn import init_params
from s3prl_tpu_torch.ops import dtw
from s3prl_tpu_torch.task import QbeEmbedder, QbeEmbeddingTask
from s3prl_tpu_torch.upstream.convert import probe_state_dict_from_jax
from test_dtw import numpy_subsequence_dtw
from test_torch_port_frame_probe import (results, run_both, same_csvs, same_metrics,  # noqa: F401
                                         same_states, same_training, tiny_pair)
from test_torch_port_w2v2 import perturbed

RECIPES = ["QbeDTW", "QbeExample", "QbeEmbeddingQuesst14", "Sws2013Embedding",
           "QbeEmbeddingExample"]


# -- the DTW ------------------------------------------------------------------------


def _features(seed, Q=3, N=5, D=16, Tq=12, Td=1499):
    """Queries of 12, 3 and 1 frames; documents of 300, 40, 1,499, 7 and
    800 frames (padded to their longest), from a numpy seed."""
    rng = np.random.RandomState(seed)
    q_lens = np.asarray([12, 3, 1][:Q], np.int64)
    d_lens = np.asarray([300, 40, 1499, 7, 800][:N], np.int64)
    return (rng.randn(Q, Tq, D).astype(np.float32), q_lens,
            rng.randn(N, Td, D).astype(np.float32), d_lens)


@functools.lru_cache(maxsize=None)
def _references(seed):
    """(JAX qbe_scores, the numpy DP's) on seed `seed`'s features."""
    q, ql, d, dl = _features(seed)
    want = np.asarray(jax_dtw.qbe_scores(jnp.asarray(q), jnp.asarray(ql), jnp.asarray(d),
                                         jnp.asarray(dl)))
    numpy = np.asarray([[-numpy_subsequence_dtw(np.asarray(jax_dtw.cosine_distance_matrix(
        jnp.asarray(q[i]), jnp.asarray(d[j]))), ql[i], dl[j]) for j in range(len(dl))]
        for i in range(len(ql))])
    return want, numpy


def test_cosine_distance_matrix_matches_jax():
    """Zero rows (norm floored at 1e-8) included."""
    q, _, d, _ = _features(0)
    q[0, 3] = 0.0
    want = np.asarray(jax_dtw.cosine_distance_matrix(jnp.asarray(q[0]), jnp.asarray(d[0, :50])))
    got = dtw.cosine_distance_matrix(torch.from_numpy(q[0]), torch.from_numpy(d[0, :50]))
    assert got.dtype == torch.float32
    np.testing.assert_allclose(got.numpy(), want, atol=1e-6, rtol=0)


@pytest.mark.parametrize("ql,dl", [(5, 12), (8, 8), (3, 20), (1, 24), (10, 1)])
def test_subsequence_dtw_cost_matches_numpy(ql, dl):
    """tests/test_dtw.py's cases and the one-row / one-column edges."""
    rng = np.random.RandomState(0)
    q = rng.randn(10, 4).astype(np.float32)
    d = rng.randn(24, 4).astype(np.float32)
    cost = np.asarray(jax_dtw.cosine_distance_matrix(jnp.asarray(q), jnp.asarray(d)))
    want = numpy_subsequence_dtw(cost, ql, dl)
    got = float(dtw.subsequence_dtw_cost(torch.from_numpy(cost.copy()), ql, dl))
    np.testing.assert_allclose(got, want, rtol=1e-5)
    np.testing.assert_allclose(got, float(jax_dtw.subsequence_dtw_cost(jnp.asarray(cost), ql,
                                                                       dl)), rtol=1e-5)


@pytest.mark.parametrize("max_gib", [2.0, 1e-6], ids=["one chunk", "a document a chunk"])
@pytest.mark.parametrize("seed", [0, 1])
def test_qbe_scores_match_jax_and_numpy(seed, max_gib):
    """[Q, N] scores of 12-, 3- and 1-frame queries over documents of 7 to
    1,499 frames; a chunk limit below one document's cost tensor takes a
    document a chunk."""
    q, ql, d, dl = _features(seed)
    want, numpy = _references(seed)
    got = dtw.qbe_scores(torch.from_numpy(q), torch.from_numpy(ql), torch.from_numpy(d),
                         torch.from_numpy(dl), max_gib=max_gib)
    assert got.dtype == torch.float32 and tuple(got.shape) == want.shape
    np.testing.assert_allclose(got.numpy(), numpy, rtol=1e-5)
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-5)


def test_qbe_scores_find_embedded_query():
    """tests/test_dtw.py's case: a query embedded verbatim in a document
    outscores a random one, by the same margin as JAX's."""
    rng = np.random.RandomState(1)
    query = rng.randn(6, 8).astype(np.float32)
    doc_match = rng.randn(30, 8).astype(np.float32)
    doc_match[10:16] = query
    docs = np.stack([doc_match, rng.randn(30, 8).astype(np.float32)])
    got = dtw.qbe_scores(torch.from_numpy(query[None]), torch.tensor([6]),
                         torch.from_numpy(docs), torch.tensor([30, 30])).numpy()
    want = np.asarray(jax_dtw.qbe_scores(jnp.asarray(query[None]), jnp.asarray([6]),
                                         jnp.asarray(docs), jnp.asarray([30, 30])))
    assert got[0, 0] > got[0, 1]
    np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-6)


# -- the embedder and its task ------------------------------------------------------

L, B, T, C = 3, 4, 20, 24
LENS = np.asarray([20, 13, 1, 7], np.int32)
KEY = jax.random.key(0)


@functools.lru_cache(maxsize=None)
def _jax_embedder(layers):
    model = JaxEmbedder(L, bottleneck_dim=8, hidden_dim=12, num_layers=layers)
    params = jax.jit(model.init)(KEY, jnp.zeros((L, B, T, C)), jnp.asarray(LENS))["params"]
    return model, perturbed(params)


def _pair(layers):
    model, params = _jax_embedder(layers)
    port = QbeEmbedder(L, C, bottleneck_dim=8, hidden_dim=12, num_layers=layers)
    port.load_state_dict(probe_state_dict_from_jax(params))
    return model, params, port


@pytest.mark.parametrize("layers", [1, 2])
def test_embedder_matches_flax(layers):
    """connector -> ReLU -> LSTMs -> tanh -> masked attentive pooling: the
    embeddings and every parameter's gradient of sum(emb * g)."""
    model, params, port = _pair(layers)
    hs = np.random.RandomState(1).randn(L, B, T, C).astype(np.float32)
    apply = jax.jit(lambda p: model.apply({"params": p}, jnp.asarray(hs), jnp.asarray(LENS)))
    got = port(torch.from_numpy(hs), torch.from_numpy(LENS))
    assert got.dtype == torch.float32 and tuple(got.shape) == (B, 12)
    np.testing.assert_allclose(got.detach().numpy(), np.asarray(apply(params)), atol=1e-5, rtol=0)
    g = np.random.RandomState(2).randn(B, 12).astype(np.float32)
    want = probe_state_dict_from_jax(jax.jit(jax.grad(lambda p: jnp.sum(apply(p) * g)))(params))
    (got * torch.from_numpy(g)).sum().backward()
    named = dict(port.named_parameters())
    assert named.keys() == want.keys()
    for k, p in named.items():
        if ".bias_ih_" in k:  # torch's second LSTM bias: held at zero
            assert p.grad is None and not p.requires_grad, k
            continue
        np.testing.assert_allclose(p.grad.numpy(), want[k].numpy(), atol=1e-5, rtol=0, err_msg=k)


def test_converter_maps_the_embedder_tree():
    """flax names the cells OptimizedLSTMCell_0 and _1 (no proj_ layers):
    one unidirectional cell a layer, each to its own lstm_{i}."""
    _, params = _jax_embedder(2)
    assert {"OptimizedLSTMCell_0", "OptimizedLSTMCell_1", "connector", "attention_linear",
            "featurizer"} == set(params)
    sd = probe_state_dict_from_jax(params)
    for i in range(2):
        kernel = np.concatenate([np.asarray(params[f"OptimizedLSTMCell_{i}"][f"i{g}"]["kernel"])
                                 for g in "ifgo"], 1)
        np.testing.assert_array_equal(sd[f"lstm_{i}.weight_ih_l0"].numpy(), kernel.T)
    assert not any("reverse" in k for k in sd)
    port = QbeEmbedder(L, C, bottleneck_dim=8, hidden_dim=12, num_layers=2)
    assert sd.keys() == port.state_dict().keys()
    init_params(port, torch.Generator().manual_seed(0))  # flax's init, every kind drawn
    assert not port.lstm_1.bias_ih_l0.any() and port.connector.weight.std() > 0


@pytest.mark.parametrize("margin", [0.0, -1.0])
def test_pair_task_matches_jax(margin):
    """The cosine pair loss (positives 1 - cos, negatives clamp(cos -
    margin, 0)) over [queries; documents], its cache and gradients; the
    reduction (loss, pair_auc) on the same records."""
    model, params, port = _pair(1)
    rng = np.random.RandomState(3)
    hs = rng.randn(L, B, T, C).astype(np.float32)
    batch = {"pair_label": np.asarray([1, -1, 1, -1], np.int32)}
    jax_task, task = JaxTask(model, margin), QbeEmbeddingTask(port, margin)
    (want, want_cache), want_grads = jax.jit(jax.value_and_grad(
        lambda p: jax_task.loss_and_cache(p, jnp.asarray(hs), jnp.asarray(LENS), batch, KEY,
                                          True), has_aux=True))(params)
    loss, cache = task.loss_and_cache(torch.from_numpy(hs), torch.from_numpy(LENS), batch,
                                      None, True)
    np.testing.assert_allclose(float(loss.detach()), float(want), rtol=1e-5)
    np.testing.assert_allclose(cache["similarity"].numpy(), np.asarray(want_cache["similarity"]),
                               atol=1e-6, rtol=0)
    np.testing.assert_array_equal(cache["pair_label"].numpy(), np.asarray(want_cache["pair_label"]))
    loss.backward()
    want_grads = probe_state_dict_from_jax(want_grads)
    for k, p in port.named_parameters():
        if p.requires_grad:
            np.testing.assert_allclose(p.grad.numpy(), want_grads[k].numpy(), atol=1e-5, rtol=0,
                                       err_msg=k)
    records = [{k: np.asarray(v) for k, v in want_cache.items()}] * 2
    assert task.reduction("test", records) == jax_task.reduction("test", records)


# -- the recipes --------------------------------------------------------------------


def test_qbe_example_matches_jax(tmp_path, same_states, monkeypatch):
    """QbeExample's two stages: stage 0's CSVs, then the features of each
    utterance at B = 1 and the DTW scores of every (query, doc) pair, the
    names equal and the scores at rtol 1e-5."""
    run_both(tmp_path, same_states, "QbeExample", monkeypatch, (jax_qbe,))
    same_csvs(tmp_path, ["queries.csv", "docs.csv"])
    import pandas as pd

    want = pd.read_csv(tmp_path / "jax" / "scores.csv")
    got = pd.read_csv(tmp_path / "port" / "scores.csv")
    assert got[["query", "doc"]].equals(want[["query", "doc"]]) and len(got) == 2
    np.testing.assert_allclose(got["score"].to_numpy(), want["score"].to_numpy(), rtol=1e-5)


def test_qbe_embedding_example_matches_jax(tmp_path, same_states):
    """QbeEmbeddingExample's three stages: stage 0's pairs, the embedder
    (bottleneck 32, one LSTM of 32) on batches of 2 pairs (queries then
    documents in one bucket), AdamW 1e-5, then the test loss and
    pair_auc."""
    run_both(tmp_path, same_states, "QbeEmbeddingExample")
    same_csvs(tmp_path, ["train.csv", "test.csv"])
    same_training(tmp_path, 1e-5, shifts=("attention_linear.bias",))
    got, want = results(tmp_path)
    same_metrics(got["test"], want["test"], ("pair_auc",))


def _quesst_tree(root):
    """quesst14Database-shaped: Audio/ (5 documents), dev_queries/ and
    eval_queries/ (2 each) and the scoring RTTMs' LEXEME rows."""
    rng = np.random.RandomState(4)
    for sub, names in (("Audio", [f"quesst14_{i:05d}" for i in range(5)]),
                       ("dev_queries", ["quesst14_dev_0001", "quesst14_dev_0002"]),
                       ("eval_queries", ["quesst14_eval_0001", "quesst14_eval_0002"])):
        (root / sub).mkdir(parents=True)
        for n in names:
            _write_wav(root / sub / f"{n}.wav", (rng.randn(1600) * 0.1).astype(np.float32))
    (root / "scoring").mkdir()
    for split, rows in (("dev", [("quesst14_dev_0001", 1), ("quesst14_dev_0001", 3),
                                 ("quesst14_dev_0002", 4)]),
                        ("eval", [("quesst14_eval_0002", 0)])):
        (root / "scoring" / f"quesst14_{split}.rttm").write_text("".join(
            f"LEXEME {q} 1 0.00 1.00 quesst14_{d:05d} <NA> <NA> <NA>\n" for q, d in rows))
    return root


def test_quesst14_pairs_equal_jax(tmp_path):
    """Stage 0 of QbeEmbeddingQuesst14: the RTTM positives and the seeded
    negatives, byte for byte."""
    root = _quesst_tree(tmp_path / "quesst14Database")
    cfg = {"prepare_data": {"quesst2014_root": str(root), "negatives_per_query": 2}}
    for pkg, ws in ((jax_problem, tmp_path / "jax"), (port_problem, tmp_path / "port")):
        ws.mkdir()
        pkg.QbeEmbeddingQuesst14().prepare_data(ws, cfg)
    same_csvs(tmp_path, ["train.csv", "test.csv"])
    assert (tmp_path / "port" / "train.csv").read_text().count(",1\n") == 3


@pytest.mark.parametrize("name", RECIPES)
def test_default_config_matches_jax(name):
    """The five recipes' defaults, key for key."""
    assert getattr(port_problem, name)().default_config() == \
        getattr(jax_problem, name)().default_config()
