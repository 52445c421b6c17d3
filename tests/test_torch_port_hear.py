"""The HEAR tasks of s3prl_tpu_torch vs s3prl_tpu (CPU): the scene task
(softmax and multilabel sigmoid) and the event task (frame BCE, onset
matching) against the JAX tasks on the same states with the JAX params
carried across, the hear-eval scores on the host, HearEventExample, a
k-fold scene recipe and a multilabel one through `Problem.run`, the
timestamp preparer's frame labels, the 30-s collation limit, and the 19
recipes' default configs.

Tolerances: losses at rtol 1e-5; scores (the sigmoid or softmax
probabilities) at atol 1e-6; gradients at atol 1e-5; top1_acc, the onset
F1 and the preparers' files equal; the rank-based scores (mAP, aucroc,
d_prime) at rtol 1e-5 after training (a tie in the scores may be ordered
otherwise by another device's rounding), equal on the same records; the
recipes' parameters by the rules of `test_torch_port_frame_probe`.
"""

import json

import numpy as np
import pytest
import torch
from hypothesis import given, settings
from hypothesis import strategies as st

import jax
import jax.numpy as jnp

import s3prl_tpu.nn.heads as jax_heads
import s3prl_tpu.problem as jax_problem
import s3prl_tpu.problem.hear as jax_hear
import s3prl_tpu.task.hear as jax_task_hear
import s3prl_tpu_torch.nn.heads as port_heads
import s3prl_tpu_torch.problem as port_problem
import s3prl_tpu_torch.task.hear as port_task_hear
from s3prl_tpu.nn.upstream import UpstreamDownstreamModel as JaxModel
from s3prl_tpu.util.pseudo_data import _write_wav
from s3prl_tpu_torch.nn import UpstreamDownstreamModel
from s3prl_tpu_torch.upstream.convert import probe_state_dict_from_jax
from test_torch_port_frame_probe import (results, run_both, same_csvs, same_metrics,  # noqa: F401
                                         same_states, same_training, tiny_pair)
from test_torch_port_w2v2 import perturbed

RECIPES = ["HearScene", "HearFSD", "HearESC50", "HearBeijingOpera", "HearCremaD", "HearGtzan",
           "HearGtzanMusicSpeech", "HearGunshot", "HearLibriCount", "HearStroke", "HearTonic",
           "HearVocal", "HearVoxLingual", "HearGSC5hr", "HearNsynth5hr", "HearEvent",
           "HearEventExample", "HearDcase2016Task2", "HearMaestro"]
RANKED = ("mAP", "aucroc", "d_prime")
SMALL = {"build_downstream": {"hidden_size": 16}, "build_batch_sampler": {"batch_size": 2},
         "train": {"total_steps": 4, "log_step": 2, "eval_step": 2, "save_step": 2}}

L, B, T, C = 3, 5, 16, 24
LENS = np.asarray([16, 9, 1, 12, 4], np.int32)
NUM_CLASSES = 6
KEY = jax.random.key(0)


def _pair(jax_head, port_head, hs):
    """(flax model, perturbed params, the port's model on them)."""
    model = JaxModel(jax_head, L)
    params = perturbed(jax.jit(model.init)(KEY, jnp.asarray(hs), jnp.asarray(LENS))["params"])
    port = UpstreamDownstreamModel(port_head, L)
    port.load_state_dict(probe_state_dict_from_jax(params))
    return model, params, port


def _check_task(jax_task, task, params, hs, batch, exact=()):
    """Loss, cache (`exact` keys equal, the rest at atol 1e-6) and every
    gradient of the task in train mode against the JAX task's."""
    (want, want_cache), grads = jax.jit(jax.value_and_grad(
        lambda p: jax_task.loss_and_cache(p, jnp.asarray(hs), jnp.asarray(LENS), batch, KEY,
                                          True), has_aux=True))(params)
    loss, cache = task.loss_and_cache(torch.from_numpy(hs), torch.from_numpy(LENS), batch,
                                      None, True)
    np.testing.assert_allclose(float(loss.detach()), float(want), rtol=1e-5)
    assert cache.keys() == want_cache.keys()
    for k in cache:
        if k in exact:
            np.testing.assert_array_equal(cache[k].numpy(), np.asarray(want_cache[k]), err_msg=k)
        elif k != "loss":
            np.testing.assert_allclose(cache[k].numpy(), np.asarray(want_cache[k]), atol=1e-6,
                                       rtol=0, err_msg=k)
    loss.backward()
    grads = probe_state_dict_from_jax(grads)
    for k, p in task.module.named_parameters():
        np.testing.assert_allclose(p.grad.numpy(), grads[k].numpy(), atol=1e-5, rtol=0, err_msg=k)
    return {k: np.asarray(v) for k, v in want_cache.items()}


@pytest.mark.parametrize("multilabel", [False, True], ids=["softmax", "multilabel"])
def test_scene_task_matches_jax(multilabel):
    """UtteranceLevel(16) -> CE (or BCE over multi-hot targets): loss,
    scores, gradients; the reduction's scores on the same records."""
    rng = np.random.RandomState(1)
    hs = rng.randn(L, B, T, C).astype(np.float32)
    model, params, port = _pair(jax_heads.UtteranceLevel(NUM_CLASSES, (16,)),
                                port_heads.UtteranceLevel(C, NUM_CLASSES, (16,)), hs)
    scores = ("mAP", "top1_acc", "d_prime", "aucroc") if multilabel else \
        ("top1_acc", "mAP", "d_prime", "aucroc")
    jax_task = jax_task_hear.ScenePredictionTask(model, NUM_CLASSES, multilabel, scores)
    task = port_task_hear.ScenePredictionTask(port, NUM_CLASSES, multilabel, scores)
    if multilabel:
        batch = {"multilabel": (rng.rand(B, NUM_CLASSES) < 0.3).astype(np.float32)}
    else:
        batch = {"class_id": rng.randint(0, NUM_CLASSES, B).astype(np.int32)}
    cache = _check_task(jax_task, task, params, hs, batch, exact=("label",))
    records = [cache, {**cache, "scores": cache["scores"][::-1]}]
    want = jax_task.reduction("test", records)
    assert task.reduction("test", records) == want
    assert set(want) == {"loss", *scores} | (set() if multilabel else {"accuracy"})


def test_nsynth_chroma_matches_jax():
    """pitch_acc and chroma_acc (the class values' pitch mod 12) on the
    same records."""
    rng = np.random.RandomState(2)
    values = np.asarray([60, 72, 61, 48, 50, 62])
    records = [{"loss": np.float32(0.5), "scores": rng.rand(7, 6).astype(np.float32),
                "label": rng.randint(0, 6, 7)} for _ in range(2)]
    got = port_task_hear.ScenePredictionTask(None, 6, False, ("pitch_acc", "chroma_acc"),
                                             values).reduction("test", records)
    want = jax_task_hear.ScenePredictionTask(None, 6, False, ("pitch_acc", "chroma_acc"),
                                             values).reduction("test", records)
    assert got == want and set(got) == {"loss", "pitch_acc", "chroma_acc", "accuracy"}


@pytest.mark.parametrize("extra", [3, -4], ids=["labels longer", "labels shorter"])
def test_event_task_matches_jax(extra):
    """FrameLevel(16) -> frame BCE over min(out_lens, T') frames, T' the
    shorter of the states' and the labels' frames; the onset matching
    within 2 frames on the same records."""
    rng = np.random.RandomState(3)
    hs = rng.randn(L, B, T, C).astype(np.float32)
    model, params, port = _pair(jax_heads.FrameLevel(NUM_CLASSES, (16,)),
                                port_heads.FrameLevel(C, NUM_CLASSES, (16,)), hs)
    jax_task = jax_task_hear.EventPredictionTask(model, NUM_CLASSES, onset_tolerance_ms=20.0)
    task = port_task_hear.EventPredictionTask(port, NUM_CLASSES, onset_tolerance_ms=20.0)
    labels = (rng.rand(B, T + extra, NUM_CLASSES) < 0.3).astype(np.int32)
    cache = _check_task(jax_task, task, params, hs, {"frame_labels": labels},
                        exact=("label", "lens"))
    records = [cache, {**cache, "scores": cache["scores"][::-1]}]
    want = jax_task.reduction("test", records)
    assert task.reduction("test", records) == want and set(want) == {"loss", "event_f1"}


@settings(max_examples=30, deadline=None)
@given(st.integers(2, 12), st.integers(1, 4), st.integers(0, 2**31 - 1),
       st.sampled_from([2, 5, 1000]))
def test_hear_scores_equal_jax(n, classes, seed, levels):
    """mean_average_precision, roc_auc and d_prime on drawn scores, ties
    included (`levels` distinct values), and classes with no positive or
    no negative."""
    rng = np.random.RandomState(seed)
    scores = rng.randint(0, levels, (n, classes)).astype(np.float32) / levels
    labels = (rng.rand(n, classes) < 0.5).astype(np.float32)
    for fn in ("mean_average_precision", "roc_auc"):
        assert getattr(port_task_hear, fn)(scores, labels) == \
            getattr(jax_task_hear, fn)(scores, labels), fn
    auc = jax_task_hear.roc_auc(scores, labels)
    assert port_task_hear.d_prime(auc) == jax_task_hear.d_prime(auc)


# -- the recipes --------------------------------------------------------------------


def test_event_example_matches_jax(tmp_path, same_states, monkeypatch):
    """HearEventExample's three stages (the JAX recipe builds its
    SUpstream in _trainer: the mirror by monkeypatch): stage 0's CSVs and
    10-ms frame labels, the frame head with Adam 1e-3 and a valid pass
    every 2 steps, the test event F1."""
    run_both(tmp_path, same_states, "HearEventExample", monkeypatch, (jax_hear,))
    same_csvs(tmp_path, ["train.csv", "valid.csv", "test.csv"])
    for f in sorted((tmp_path / "jax" / "events").glob("*.npy")):
        assert np.array_equal(np.load(f), np.load(tmp_path / "port" / "events" / f.name)), f.name
    same_training(tmp_path, 1e-3)
    got, want = results(tmp_path)
    same_metrics(got["test"], want["test"], ("event_f1",))


def _clips(root, names, rng, secs=0.5):
    root.mkdir(parents=True, exist_ok=True)
    for n in names:
        _write_wav(root / n, (rng.randn(int(16000 * secs)) * 0.1).astype(np.float32))


def test_kfold_scene_recipe_matches_jax(tmp_path, same_states):
    """HearESC50 on a 5-fold task directory (16000/foldNN/ audio, test
    fold 2, valid fold 3): the CSVs and encoder, 4 steps of Adam 1e-3,
    then top1_acc (equal) and mAP, d_prime, aucroc."""
    rng = np.random.RandomState(1)
    task_dir = tmp_path / "task"
    for fold in range(5):
        names = [f"f{fold}_{i}.wav" for i in range(2)]
        _clips(task_dir / "16000" / f"fold{fold:02d}", names, rng)
        (task_dir / f"fold{fold:02d}.json").write_text(json.dumps(
            {n: ["dog", "rain", "bird"][(fold + i) % 3] for i, n in enumerate(names)}))
    run_both(tmp_path, same_states, "HearESC50", prepare_data={"task_dir": str(task_dir),
                                                               "test_fold": 2}, **SMALL)
    same_csvs(tmp_path, ["train.csv", "valid.csv", "test.csv", "encoder.json"])
    same_training(tmp_path, 1e-3)
    got, want = results(tmp_path)
    same_metrics(got["test"], want["test"], ("top1_acc", "accuracy"), RANKED)


def test_multilabel_scene_recipe_matches_jax(tmp_path, same_states):
    """HearFSD on a train/valid/test task directory (audio/<split>/):
    multi-hot targets from ';'-joined labels, sigmoid BCE, then mAP,
    top1_acc, d_prime, aucroc."""
    rng = np.random.RandomState(2)
    task_dir = tmp_path / "task"
    for split, n in (("train", 6), ("valid", 2), ("test", 3)):
        names = [f"{split}_{i}.wav" for i in range(n)]
        _clips(task_dir / "audio" / split, names, rng)
        (task_dir / f"{split}.json").write_text(json.dumps(
            {name: [["dog"], ["rain", "dog"], ["bird"]][i % 3] for i, name in enumerate(names)}))
    run_both(tmp_path, same_states, "HearFSD", prepare_data={"task_dir": str(task_dir)}, **SMALL)
    same_csvs(tmp_path, ["train.csv", "valid.csv", "test.csv", "encoder.json"])
    same_training(tmp_path, 1e-3)
    got, want = results(tmp_path)
    same_metrics(got["test"], want["test"], ("top1_acc",), RANKED)


@pytest.mark.parametrize("name", ["HearDcase2016Task2", "HearMaestro"])
def test_timestamp_preparer_equals_jax(tmp_path, name):
    """Stage 0 of the timestamp recipes: events in ms -> 10-ms frame
    labels (.npy), the CSVs and classes.json, byte for byte; train /
    valid / test files (DCASE) or 5 folds (MAESTRO)."""
    rng = np.random.RandomState(3)
    task_dir = tmp_path / "task"
    metas = ([f"fold{i:02d}" for i in range(5)] if name == "HearMaestro"
             else ["train", "valid", "test"])
    for meta in metas:
        names = [f"{meta}_{i}.wav" for i in range(2)]
        _clips(task_dir / "audio" / meta, names, rng, secs=1.0)
        (task_dir / f"{meta}.json").write_text(json.dumps({n: [
            {"label": ["beep", "clap", "knock"][(i + len(meta)) % 3], "start": 100.0 + 35 * i,
             "end": 380.0}, {"label": "beep", "start": 905.0, "end": 1200.0}]
            for i, n in enumerate(names)}))
    cfg = {"prepare_data": {"task_dir": str(task_dir), "test_fold": 1}}
    for pkg, ws in ((jax_problem, tmp_path / "jax"), (port_problem, tmp_path / "port")):
        ws.mkdir()
        getattr(pkg, name)().prepare_data(ws, cfg)
    same_csvs(tmp_path, ["train.csv", "valid.csv", "test.csv", "classes.json"])
    events = sorted(p.name for p in (tmp_path / "jax" / "events").glob("*.npy"))
    assert events == sorted(p.name for p in (tmp_path / "port" / "events").glob("*.npy"))
    for f in events:
        a, b = np.load(tmp_path / "jax" / "events" / f), np.load(tmp_path / "port" / "events" / f)
        assert a.dtype == b.dtype and np.array_equal(a, b) and a.shape[0] == 100, f


def test_clips_over_30_s_fail_collation_as_in_jax(tmp_path):
    """The loaders pad into 1-s buckets of at most 30 s; a 31-s clip
    fails pad_stack's assert in both packages (ROADMAP.md Queue 3, not a
    port fault)."""
    rng = np.random.RandomState(4)
    _clips(tmp_path / "wavs", ["long.wav"], rng, secs=31.0)
    np.save(tmp_path / "long.npy", np.zeros((3100, 2), np.int32))
    (tmp_path / "test.csv").write_text(
        f"id,wav_path,events_path\nlong,{tmp_path / 'wavs' / 'long.wav'},{tmp_path / 'long.npy'}\n")
    config = {"build_batch_sampler": {"batch_size": 1}}
    for pkg in (jax_problem, port_problem):
        loader = pkg.HearEvent()._loader(tmp_path, "test.csv", "test", config)
        with pytest.raises(AssertionError, match="480000, 496000"):
            next(iter(loader))


@pytest.mark.parametrize("name", RECIPES)
def test_default_config_matches_jax(name):
    """The 19 recipes' defaults, key for key."""
    assert getattr(port_problem, name)().default_config() == \
        getattr(jax_problem, name)().default_config()
