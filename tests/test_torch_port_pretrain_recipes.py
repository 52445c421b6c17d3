"""The pretraining recipes of s3prl_tpu_torch end to end (CPU):
PretrainExample (TERA), PretrainHubertExample and PretrainData2VecExample
through `Problem.run` (train, save, resume) and the ``run_pretrain`` CLI,
their train directories through ``hub.load`` (the entries' configs patched
to the recipes' tiny ones); the Trainer's `post_update` after every
micro-step (accumulation too) and AdamW's decay of the EMA teacher;
`prepare_units`' units against the JAX package's pipeline given the same
centroids; `dump_features`; every recipe's default config equal to the JAX
package's.
"""

import json

import numpy as np
import pandas as pd
import pytest
import torch

import jax.numpy as jnp

import s3prl_tpu.problem.pretrain as jax_pretrain
import s3prl_tpu_torch.problem.pretrain as port_pretrain
import s3prl_tpu_torch.upstream.registry as port_registry
from s3prl_tpu.models.baseline import baseline_features as jax_features
from s3prl_tpu.ops.kmeans import kmeans_assign as jax_assign
from s3prl_tpu_torch import hub
from s3prl_tpu_torch.data.audio import load_wav
from s3prl_tpu_torch.run_pretrain import RECIPE_TO_PROBLEM
from s3prl_tpu_torch.run_pretrain import main as run_pretrain
from s3prl_tpu_torch.task.dump_feature import dump_features
from s3prl_tpu_torch.train.trainer import Trainer, TrainerConfig
from test_torch_port_mel_ssl import tiny_entries  # noqa: F401

PROBLEMS = ["PretrainMockingjay", "PretrainTera", "PretrainAudioAlbert", "PretrainAPC",
            "PretrainVqApc", "PretrainNPC", "PretrainSpecAugment", "PretrainDistiller",
            "PretrainExample", "PretrainHubert", "PretrainHubertExample", "PretrainData2Vec",
            "PretrainData2VecExample"]


def _run(problem, workspace, **overrides):
    config = problem.default_config()
    config.pop("target_dir")
    config.update(device="cpu", **overrides)
    problem.run(str(workspace), **config)
    return [json.loads(line) for line in (workspace / "train" / "metrics.jsonl").open()]


def test_default_configs_and_registry():
    assert sorted(RECIPE_TO_PROBLEM) == sorted(__import__(
        "s3prl_tpu.run_pretrain", fromlist=["x"]).RECIPE_TO_PROBLEM)
    for name in PROBLEMS:
        assert getattr(port_pretrain, name)().default_config() == \
            getattr(jax_pretrain, name)().default_config(), name
        assert getattr(port_pretrain, name).STAGES == getattr(jax_pretrain, name).STAGES


def test_pretrain_example_train_resume_cli_and_hub(tiny_entries, tmp_path):  # noqa: F811
    records = _run(port_pretrain.PretrainExample(), tmp_path / "ex")
    train = [r for r in records if r["mode"] == "train"]
    assert [r["step"] for r in train] == [2, 4] and all(np.isfinite(r["loss"]) for r in records)
    assert any(r["mode"] == "valid" for r in records)
    # resume: four more steps from step_4
    cfg = port_pretrain.PretrainExample().default_config()
    records = _run(port_pretrain.PretrainExample(), tmp_path / "ex",
                   train={**cfg["train"], "total_steps": 6})
    assert [r["step"] for r in records if r["mode"] == "train"][-1] == 6
    # the train dir's TERA encoder through the hub: the task module's encoder
    up = hub.load("tera", ckpt=str(tmp_path / "ex" / "train"), device="cpu")
    sd = torch.load(tmp_path / "ex" / "train" / "step_6" / "model.pt", weights_only=True)
    enc = {k[len("encoder."):]: v for k, v in sd.items() if k.startswith("encoder.")}
    for k, v in up.model.model.state_dict().items():
        assert torch.equal(v, enc[k]), k
    # the CLI
    run_pretrain(["-u", "example", "-n", str(tmp_path / "cli"), "-o",
                  "device=cpu,,train.total_steps=2,,train.eval_step=100"])
    assert (tmp_path / "cli" / "train" / "step_2" / "model.pt").exists()
    with pytest.raises(SystemExit, match="unknown recipe"):
        run_pretrain(["-u", "npc", "-n", str(tmp_path / "x")])


@pytest.mark.parametrize("recipe", ["PretrainHubertExample", "PretrainData2VecExample"])
def test_waveform_recipes_and_their_checkpoints(monkeypatch, tmp_path, recipe):
    records = _run(getattr(port_pretrain, recipe)(), tmp_path)
    assert [r["step"] for r in records] == [1, 2]
    assert all(np.isfinite(r["loss"]) for r in records)
    sd = torch.load(tmp_path / "train" / "step_2" / "model.pt", weights_only=True)
    prefix = "trunk." if recipe == "PretrainHubertExample" else "student."
    trunk = {k[len(prefix):]: v for k, v in sd.items() if k.startswith(prefix)}
    if recipe == "PretrainData2VecExample":  # the teacher moved toward the student
        teacher = {k[len("teacher."):]: v for k, v in sd.items() if k.startswith("teacher.")}
        assert teacher.keys() == trunk.keys()
        assert any(not torch.equal(teacher[k], trunk[k]) for k in trunk)
    cfg = port_pretrain._tiny_trunk()
    monkeypatch.setattr(port_registry, "HUBERT_BASE", cfg)
    monkeypatch.setattr(port_registry, "DATA2VEC_BASE", cfg)
    name = "hubert" if recipe == "PretrainHubertExample" else "data2vec"
    up = hub.load(name, ckpt=str(tmp_path / "train"), device="cpu")
    for k, v in up.model.state_dict().items():
        assert torch.equal(v, trunk[k]), k
    # the task's student states are the upstream's
    x = torch.from_numpy(np.random.RandomState(0).randn(2, 8000).astype(np.float32))
    lens = torch.tensor([8000, 5000])
    hs, _ = up.model(x, lens)
    task = getattr(port_pretrain, recipe)().build_task(
        getattr(port_pretrain, recipe)().default_config())
    task.module.load_state_dict(sd)
    module = task.module.trunk if name == "hubert" else task.module.student
    with torch.no_grad():
        assert torch.equal(module.eval()(x, lens)[0], hs)


def test_post_update_after_every_micro_step(tmp_path):
    """data2vec's EMA runs after every micro-step, also the ones the
    accumulation holds (the JAX trainer's post_update after apply_updates)."""
    problem = port_pretrain.PretrainData2VecExample()
    config = problem.default_config()
    problem.prepare_data(tmp_path, config)
    task = problem.build_task(config)
    calls = []
    post = task.post_update
    task.post_update = lambda: calls.append(1) or post()
    trainer = Trainer(hub.load("wav", device="cpu"), task, tmp_path / "train",
                      TrainerConfig(total_steps=3, log_step=1, eval_step=10, save_step=10,
                                    gradient_accumulate=2, tensorboard=False))
    trainer.init(resume=False)
    before = {k: v.clone() for k, v in task.module.teacher.state_dict().items()}
    trainer.train(problem._loader(tmp_path, "train.csv", config))
    assert len(calls) == 3 and trainer.optimizer.count == 1
    assert any(not torch.equal(v, task.module.teacher.state_dict()[k]) for k, v in before.items())


def test_prepare_units_against_jax_pipeline(tmp_path):
    """The units of every utterance: one a JAX MFCC frame of the JAX
    pipeline (padded to whole seconds, every second frame), equal on >= 99%
    of the frames to JAX's assignment of its own MFCC to the port's
    centroids; the CSVs gain units_path, and a second call leaves them."""
    class Tones(port_pretrain.PretrainHubertExample):
        def prepare_data(self, workspace, config):
            port_pretrain.PretrainExample.prepare_data(self, workspace, config)

    problem = Tones()
    config = problem.default_config()
    config.update(device="cpu", prepare_units={"num_clusters": 4, "iters": 5,
                                               "max_fit_frames": 400})
    problem.prepare_data(tmp_path, config)
    problem.prepare_units(tmp_path, config)
    centroids = np.load(tmp_path / "units" / "centroids.npy")
    assert centroids.shape == (4, 39)
    df = pd.read_csv(tmp_path / "train.csv")
    for _, row in df.head(3).iterrows():
        wav, _ = load_wav(row["wav_path"], 16000, 0.0, 15.0)
        n = max(len(wav), 400)
        w = np.pad(wav, (0, -(-n // 16000) * 16000 - len(wav)))[None]
        f, fl = jax_features(jnp.asarray(w), jnp.asarray([n]), feat_type="mfcc", num_ceps=13,
                             delta_order=2, cmvn=False)
        f = np.asarray(f[0], np.float32)[: int(fl[0])][::2]
        units = np.load(row["units_path"])
        assert units.dtype == np.int32 and len(units) == len(f)
        want = np.asarray(jax_assign(jnp.asarray(f), jnp.asarray(centroids)))
        assert (units == want).mean() >= 0.99
    # a second call finds the labels and leaves them
    problem.prepare_units(tmp_path, config)
    assert pd.read_csv(tmp_path / "train.csv")["units_path"].tolist() == df["units_path"].tolist()


def test_dump_features(tmp_path):
    problem = port_pretrain.PretrainExample()
    config = problem.default_config()
    problem.prepare_data(tmp_path, config)
    up = hub.load("mel", device="cpu")
    paths = dump_features(up, problem._loader(tmp_path, "valid.csv", config), tmp_path / "f")
    assert len(paths) == 4
    for p in paths:
        arr = np.load(p)
        assert arr.ndim == 2 and arr.shape[1] == 80 and np.isfinite(arr).all()


def test_adamw_decays_the_ema_teacher_as_optax(tmp_path):
    """The optimizer covers the whole module, the EMA teacher too (its
    gradient zero), as optax covers the whole tree: under AdamW one step
    leaves the teacher at d t (1 - lr wd) + (1 - d) s', optax's decayed
    weights then JAX's EMA (s3prl_tpu/train/optimizers.py:53-54)."""
    problem = port_pretrain.PretrainData2VecExample()
    config = problem.default_config()
    problem.prepare_data(tmp_path, config)
    task = problem.build_task(config)
    lr, wd, d = 1e-2, 0.1, 0.9
    trainer = Trainer(hub.load("wav", device="cpu"), task, tmp_path / "train", TrainerConfig(
        total_steps=10, tensorboard=False,
        optimizer={"name": "AdamW", "lr": lr, "weight_decay": wd}))
    trainer.init(resume=False)
    teacher0 = {k: v.clone() for k, v in task.module.teacher.state_dict().items()}
    batch = next(iter(problem._loader(tmp_path, "train.csv", config)))
    trainer.train_step({k: v for k, v in batch.items() if k in ("x", "x_len")})
    student = task.module.student.state_dict()
    for k, v in task.module.teacher.state_dict().items():
        want = d * (teacher0[k] * (1 - lr * wd)) + (1 - d) * student[k]
        assert torch.allclose(v, want, atol=1e-6, rtol=0), k
