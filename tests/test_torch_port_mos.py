"""MOS prediction in s3prl_tpu_torch vs s3prl_tpu (CPU): the segment
mean-net and the judge bias-net against flax through
`probe_state_dict_from_jax`, the task's loss and cache in train (judge
ids) and eval, its reduction, the converter's ``nn.Embed`` rule and
flax's embedding initialisation, MosExample through `Problem.run`, the
VCC2018 preparer's CSVs and the two recipes' default configs.

The segments follow the batch's padded T (``T // 25`` windows of 50 frames
when T > 50, else one), so each case runs at a padded T above the longest
row; the attention softmax runs over all 50 frames of a window, padding
included, and the valid windows come from h_lens. Tolerances: outputs at
atol 1e-5, every gradient at atol 1e-5 and rtol 1e-5 (a bias's gradient
sums up to 6 windows x 50 frames a row, and reaches 5); losses at rtol
1e-5; the reduction equal on the same records; after training, the utterance and system MSE, LCC and
SRCC at rtol 1e-5 (the predictions differ by f32 rounding), the
parameters by the rules of `test_torch_port_frame_probe` (each attention
pooling's score bias is a shift: its gradient is zero but for rounding).
"""

import functools

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

import s3prl_tpu.problem as jax_problem
import s3prl_tpu_torch.problem as port_problem
from s3prl_tpu.task.mos_prediction import MosDownstreamModule as JaxModule
from s3prl_tpu.task.mos_prediction import MosPredictionTask as JaxTask
from s3prl_tpu_torch.nn import init_params
from s3prl_tpu_torch.task import MosDownstreamModule, MosPredictionTask
from s3prl_tpu_torch.upstream.convert import probe_state_dict_from_jax
from test_torch_port_frame_probe import (results, run_both, same_csvs, same_metrics,  # noqa: F401
                                         same_states, same_training, tiny_pair)
from test_torch_port_w2v2 import perturbed

L, C, D, JUDGES = 3, 24, 16, 9
KEY = jax.random.key(0)
# (padded T, h_lens): one window (T <= 50), several with rows shorter than
# the padded T (n_seg from T, not from h_lens), rows of exactly 50 and 51
CASES = {"T 40": (40, [40, 23, 1]), "T 101": (101, [88, 51, 50]), "T 160": (160, [150, 76, 12])}
OPTIONS = {"clipping, attention": (True, True), "no clipping, mean": (False, False)}


@functools.lru_cache(maxsize=None)
def _jax_module(option):
    clipping, attention = OPTIONS[option]
    model = JaxModule(L, projector_dim=D, num_judges=JUDGES, clipping=clipping,
                      attention_pooling=attention)
    params = jax.jit(model.init)(KEY, jnp.zeros((L, 3, 60, C)), jnp.asarray([60, 30, 1]),
                                 jnp.asarray([0, 1, 2]))["params"]
    return model, perturbed(params)


def _pair(option):
    model, params = _jax_module(option)
    clipping, attention = OPTIONS[option]
    port = MosDownstreamModule(L, C, projector_dim=D, num_judges=JUDGES, clipping=clipping,
                               attention_pooling=attention)
    port.load_state_dict(probe_state_dict_from_jax(params))
    return model, params, port


def _inputs(case, seed):
    T, lens = CASES[case]
    rng = np.random.RandomState(seed)
    hs = rng.randn(L, len(lens), T, C).astype(np.float32)
    return hs, np.asarray(lens, np.int32), rng.randint(0, JUDGES, len(lens)).astype(np.int32)


@pytest.mark.parametrize("option", list(OPTIONS))
@pytest.mark.parametrize("case", list(CASES))
def test_module_matches_flax(case, option):
    """(segment scores, bias scores, segment mask) with judge ids, and
    every parameter's gradient of a weighted sum of both scores."""
    model, params, port = _pair(option)
    hs, lens, judges = _inputs(case, 1)
    apply = jax.jit(lambda p: model.apply({"params": p}, jnp.asarray(hs), jnp.asarray(lens),
                                          judge_ids=jnp.asarray(judges)))
    want = apply(params)
    got = port(torch.from_numpy(hs), torch.from_numpy(lens), torch.from_numpy(judges).long())
    n_seg = max(CASES[case][0] // 25, 1) if CASES[case][0] > 50 else 1
    assert tuple(got[0].shape) == (3, n_seg)
    for g, w in zip(got, want):
        np.testing.assert_allclose(g.detach().numpy(), np.asarray(w), atol=1e-5, rtol=0)
    ga, gb = (np.random.RandomState(s).randn(3, n_seg).astype(np.float32) for s in (2, 3))
    grads = probe_state_dict_from_jax(jax.jit(jax.grad(
        lambda p: jnp.sum(apply(p)[0] * ga + apply(p)[1] * gb)))(params))
    (got[0] * torch.from_numpy(ga) + got[1] * torch.from_numpy(gb)).sum().backward()
    named = dict(port.named_parameters())
    assert named.keys() == grads.keys()
    for k, p in named.items():
        np.testing.assert_allclose(p.grad.numpy(), grads[k].numpy(), atol=1e-5, rtol=1e-5,
                                   err_msg=k)


@pytest.mark.parametrize("train", [True, False], ids=["train", "eval"])
@pytest.mark.parametrize("case", list(CASES))
def test_task_matches_jax(case, train):
    """The segment, utterance and (in train, with judge ids) bias losses,
    the cache; the reduction on the same records: utterance and system
    MSE, LCC, SRCC."""
    model, params, port = _pair("clipping, attention")
    hs, lens, judges = _inputs(case, 4)
    rng = np.random.RandomState(5)
    batch = {"mean": rng.uniform(1, 5, 3).astype(np.float32),
             "mos": rng.uniform(1, 5, 3).astype(np.float32), "judge_id": judges}
    jax_task, task = JaxTask(model, 0.7, 1.3), MosPredictionTask(port, 0.7, 1.3)
    (want, want_cache), grads = jax.jit(jax.value_and_grad(
        lambda p: jax_task.loss_and_cache(p, jnp.asarray(hs), jnp.asarray(lens), batch, KEY,
                                          train), has_aux=True))(params)
    loss, cache = task.loss_and_cache(torch.from_numpy(hs), torch.from_numpy(lens), batch,
                                      None, train)
    np.testing.assert_allclose(float(loss.detach()), float(want), rtol=1e-5)
    np.testing.assert_allclose(cache["prediction"].numpy(), np.asarray(want_cache["prediction"]),
                               atol=1e-6, rtol=0)
    np.testing.assert_array_equal(cache["mean"].numpy(), np.asarray(want_cache["mean"]))
    loss.backward()
    grads = probe_state_dict_from_jax(grads)
    for k, p in port.named_parameters():
        if p.grad is None:  # the bias net in eval
            assert not train and (k.startswith(("judge_", "bias_net")) or
                                  not np.asarray(grads[k]).any()), k
            continue
        np.testing.assert_allclose(p.grad.numpy(), grads[k].numpy(), atol=1e-5, rtol=1e-5,
                                   err_msg=k)
    records = [{**{k: np.asarray(v) for k, v in want_cache.items()},
                "system_name": ["sysA", "sysB", "sysA"]},
               {"loss": np.float32(1.5), "prediction": np.asarray([2.5, 3.0, 1.0], np.float32),
                "mean": np.asarray([2.0, 4.0, 1.5], np.float32),
                "system_name": ["sysC", "sysB", "sysC"]}]
    want = jax_task.reduction("test", records)
    assert task.reduction("test", records) == want
    assert {"utt_MSE", "utt_LCC", "utt_SRCC", "sys_MSE", "sys_LCC", "sys_SRCC"} <= set(want)


def test_converter_and_embedding_init():
    """flax nn.Embed's ``embedding`` [num, features] becomes
    nn.Embedding's ``weight`` (no transpose); init_params draws it as
    flax does, a normal of standard deviation 1 / sqrt(features) (not
    truncated), beside flax's own draw at 5,000 judges x 256."""
    _, params = _jax_module("clipping, attention")
    sd = probe_state_dict_from_jax(params)
    assert "judge_embedding.embedding" not in sd
    np.testing.assert_array_equal(sd["judge_embedding.weight"].numpy(),
                                  np.asarray(params["judge_embedding"]["embedding"]))
    module = MosDownstreamModule(L, C, projector_dim=256, num_judges=5000)
    init_params(module, torch.Generator().manual_seed(0))
    w = module.judge_embedding.weight.detach().numpy()
    flax_w = np.asarray(JaxModule(L, projector_dim=256, num_judges=5000).init(
        KEY, jnp.zeros((L, 1, 60, C)), jnp.asarray([60]), jnp.asarray([0]))
        ["params"]["judge_embedding"]["embedding"])
    for draw in (w, flax_w):
        assert abs(draw.std() * 16 - 1) < 0.01 and abs(draw.mean()) < 1e-3
        assert np.abs(draw).max() > 4 / 16  # a plain normal: tails past 2 sigma
    assert not module.connector.bias.any() and module.connector.weight.std() > 0


def test_mos_example_matches_jax(tmp_path, same_states):
    """MosExample's three stages: stage 0's CSVs (judge ids, system
    names), training with the judge bias-net (Adam 1e-4, valid every 2
    steps), the test MSE / LCC / SRCC at utterance and system level."""
    run_both(tmp_path, same_states, "MosExample")
    same_csvs(tmp_path, ["train.csv", "valid.csv", "test.csv"])
    same_training(tmp_path, 1e-4, shifts=("mean_net_pooling.bias", "bias_net_pooling.bias"))
    got, want = results(tmp_path)
    metrics = ("utt_MSE", "utt_LCC", "utt_SRCC", "sys_MSE", "sys_LCC", "sys_SRCC")
    same_metrics(got["test"], want["test"], (), metrics)


def test_vcc2018_preparer_equals_jax(tmp_path):
    """Stage 0 of MosPrediction on a VCC2018-shaped tree: per-wav means,
    judge ids across the splits, system names, the test split one row a
    wav; byte for byte."""
    root = tmp_path / "vcc2018"
    root.mkdir()
    rng = np.random.RandomState(6)
    for csv_name, n in (("vcc2018_training_data.csv", 8), ("vcc2018_valid_data.csv", 3),
                        ("vcc2018_testing_data.csv", 6)):
        rows = [f"{['B01', 'D03', 'N10'][i % 3]}_VCC2SF{i % 2 + 1}_3000{i % 4}.wav,"
                f"{rng.randint(1, 6)},judge{rng.randint(0, 4)}" for i in range(n)]
        (root / csv_name).write_text("WAV_PATH,MOS,JUDGE\n" + "\n".join(rows) + "\n")
    cfg = {"prepare_data": {"vcc2018": str(root)}}
    for pkg, ws in ((jax_problem, tmp_path / "jax"), (port_problem, tmp_path / "port")):
        ws.mkdir()
        pkg.MosPrediction().prepare_data(ws, cfg)
    same_csvs(tmp_path, ["train.csv", "valid.csv", "test.csv"])


@pytest.mark.parametrize("name", ["MosPrediction", "MosExample"])
def test_default_config_matches_jax(name):
    assert getattr(port_problem, name)().default_config() == \
        getattr(jax_problem, name)().default_config()
