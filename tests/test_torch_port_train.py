"""The training runtime of s3prl_tpu_torch vs s3prl_tpu (CPU): the Trainer
against the JAX Trainer, the frozen upstream's kernel route inside a step,
and auto-resume.

One tiny trunk (two pre-LN layers, C 128, the real seven-layer conv stack
at 64 channels) carries the same weights in both packages; both trainers
take the same numpy batches, and the port's probe starts from the JAX
probe's initial params (captured from the JAX task's `init_params`,
carried by `probe_state_dict_from_jax`). Tolerances: per-step losses and
gradient norms at rtol 1e-5, the final probe parameters (three Adam
updates of lr 1e-3) at atol 1e-6: f32 sums in other orders (measured:
4e-7 and 7e-8).
"""

import json

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

import s3prl_tpu.nn.heads as jax_heads
import s3prl_tpu_torch.kernels.conv_frontend as port_cf
import s3prl_tpu_torch.models.convfe as port_convfe
import s3prl_tpu_torch.models.transformer as port_transformer
import s3prl_tpu_torch.nn.heads as port_heads
from s3prl_tpu.nn.upstream import UpstreamDownstreamModel as JaxModel
from s3prl_tpu.task.utterance_classification import UtteranceClassificationTask as JaxTask
from s3prl_tpu.train.trainer import Trainer as JaxTrainer
from s3prl_tpu.train.trainer import TrainerConfig as JaxTrainerConfig
from s3prl_tpu_torch.models.wav2vec2 import Wav2Vec2Config, Wav2Vec2Trunk
from s3prl_tpu_torch.nn.upstream import UpstreamDownstreamModel
from s3prl_tpu_torch.parallel.mesh import Mesh
from s3prl_tpu_torch.task import FrameClassificationTask, UtteranceClassificationTask
from s3prl_tpu_torch.train import checkpoint as ckpt
from s3prl_tpu_torch.train.trainer import Trainer, TrainerConfig
from s3prl_tpu_torch.upstream.base import Upstream
from s3prl_tpu_torch.upstream.convert import probe_state_dict_from_jax, trunk_state_dict_from_jax
from test_torch_port_probe import TINY, tiny_pair  # noqa: F401 (fixture)

TRAIN = dict(total_steps=3, log_step=1, eval_step=100, save_step=100, tensorboard=False,
             optimizer={"name": "Adam", "lr": 1e-3})


def _batches(n=3, B=3, T=6400, classes=4, seed=11):
    rng = np.random.RandomState(seed)
    out = []
    for i in range(n):
        lens = np.asarray([T, T - 1500 * (i + 1), 401], np.int32)
        x = (rng.randn(B, T) * (np.arange(T) < lens[:, None])).astype(np.float32)
        out.append({"x": x, "x_len": lens,
                    "class_id": rng.randint(0, classes, B).astype(np.int32),
                    "unique_name": [f"u{i}_{b}" for b in range(B)]})
    return out


class _Loader:
    """The same batches every epoch."""

    def __init__(self, batches):
        self.batches = batches

    def set_epoch(self, epoch):
        pass

    def __iter__(self):
        return iter(self.batches)


def _losses(exp_dir, key="loss"):
    rows = [json.loads(line) for line in (exp_dir / "metrics.jsonl").read_text().splitlines()]
    return [r[key] for r in rows if r["mode"] == "train"]


def capture_init(task, captured=None):
    """Records the JAX task's initial params (the trainer's key, shapes)
    in `captured`["params"]."""
    init, captured = task.init_params, {} if captured is None else captured

    def init_params(*args):
        captured["params"] = init(*args)
        return captured["params"]

    task.init_params = init_params
    return captured


def start_from(task, captured):
    """The port task starts from the captured JAX params."""
    task.init_params = lambda generator=None: task.module.load_state_dict(
        probe_state_dict_from_jax(captured["params"]))
    return task


def test_trainer_matches_jax(tiny_pair, tmp_path):
    """Three steps of frozen-upstream probe training (featurizer ->
    UtteranceLevel(8) -> CE -> clip -> Adam) in both trainers."""
    jax_up, port_up = tiny_pair
    batches = _batches()
    jax_task = JaxTask(JaxModel(jax_heads.UtteranceLevel(4, (8,)), 3), 4)
    captured = capture_init(jax_task)
    jax_trainer = JaxTrainer(jax_up, jax_task, tmp_path / "jax", JaxTrainerConfig(**TRAIN))
    jax_trainer.train(_Loader(batches))
    task = start_from(UtteranceClassificationTask(
        UpstreamDownstreamModel(port_heads.UtteranceLevel(128, 4, (8,)), 3), 4), captured)
    trainer = Trainer(port_up, task, tmp_path / "port", TrainerConfig(**TRAIN))
    trainer.train(_Loader(batches))
    assert trainer.step == jax_trainer.step == 3 and not port_up.model.training
    for key in ("loss", "grad_norm"):
        want, got = _losses(tmp_path / "jax", key), _losses(tmp_path / "port", key)
        assert len(got) == len(want) == 3
        np.testing.assert_allclose(got, want, rtol=1e-5)
    want = probe_state_dict_from_jax(jax.device_get(jax_trainer.params))
    got = trainer.task.module.state_dict()
    assert got.keys() == want.keys()
    for k in want:
        np.testing.assert_allclose(got[k].numpy(), want[k].numpy(), atol=1e-6, rtol=0,
                                   err_msg=k)
    assert not torch.equal(got["featurizer.weights"], torch.zeros(3))
    assert ckpt.latest_checkpoint(tmp_path / "port").name == "step_3"


def _spy(monkeypatch, module, name, calls):
    fn = getattr(module, name)

    def spy(*args, **kwargs):
        calls.append((name, torch.is_grad_enabled(), args[0].requires_grad))
        return fn(*args, **kwargs)

    monkeypatch.setattr(module, name, spy)


def test_frozen_int8_upstream_takes_the_kernel_route(tiny_pair, monkeypatch, tmp_path):
    """int8 W8A8 (bf16, flash, quantize) tiny trunk, its CPU kernel route
    switched on: every step calls K3 once and K1 and K2 once a layer, each
    with autograd off on an input that requires no grad, the upstream in
    eval() throughout, while the probe trains."""
    _, port_up = tiny_pair
    cfg = Wav2Vec2Config(**TINY)
    model = Wav2Vec2Trunk(cfg, dtype=torch.bfloat16, use_flash=True, quantize=True,
                          device="meta")
    model.to_empty(device="cpu")
    model.load_state_dict(port_up.model.state_dict())  # builds the int8 cache
    up = Upstream("tiny", model.eval(), 3, 128, 320)
    monkeypatch.setattr(port_transformer, "_fused_block_available", lambda x: True)
    calls = []
    _spy(monkeypatch, port_transformer, "fused_attention_block", calls)
    _spy(monkeypatch, port_transformer, "fused_int8_ffn", calls)
    _spy(monkeypatch, port_convfe, "conv0_ln_gelu", calls)
    _spy(monkeypatch, port_cf, "conv0_ln_gelu_reference", calls)
    task = UtteranceClassificationTask(
        UpstreamDownstreamModel(port_heads.UtteranceLevel(128, 4, (8,)), 3), 4)
    trainer = Trainer(up, task, tmp_path, TrainerConfig(**dict(TRAIN, total_steps=2)))
    trainer.init()
    start = {k: v.clone() for k, v in task.module.state_dict().items()}
    modes = []
    for batch in _batches(2):
        loss, _, _ = trainer.train_step(batch)
        modes.append((model.training, task.module.training))
        assert torch.isfinite(loss)
    names = [name for name, _, _ in calls]
    assert names.count("conv0_ln_gelu") == 2 and names.count("conv0_ln_gelu_reference") == 2
    assert names.count("fused_attention_block") == names.count("fused_int8_ffn") == 4
    assert all(not grad and not requires for _, grad, requires in calls)
    assert modes == [(False, True)] * 2
    assert not torch.equal(start["featurizer.weights"], task.module.featurizer.weights)


def test_resume_repeats_the_steps(tiny_pair, tmp_path):
    """A run stopped at step 2 and resumed ends where an uninterrupted run
    ends: weights, Adam moments and count, accumulation state and the
    head's dropout draws (seeded from (seed, step)) come back; a finished
    run resumes to no new step."""
    _, port_up = tiny_pair
    batch = _batches(1)[0]

    def task():
        head = port_heads.ConvBankHead(128, 4, (3,), 8, 16, dropout=0.3)
        return FrameClassificationTask(UpstreamDownstreamModel(head, 3), 4)

    cfg = dict(TRAIN, total_steps=4, save_step=2, gradient_accumulate=2)
    whole = Trainer(port_up, task(), tmp_path / "whole", TrainerConfig(**cfg))
    whole.train(_Loader([batch]))
    Trainer(port_up, task(), tmp_path / "parts", TrainerConfig(**dict(cfg, total_steps=2))
            ).train(_Loader([batch]))
    resumed = Trainer(port_up, task(), tmp_path / "parts", TrainerConfig(**cfg))
    resumed.train(_Loader([batch]))
    assert resumed.step == whole.step == 4 and resumed.optimizer.count == 2
    for (k, a), b in zip(whole.task.module.state_dict().items(),
                         resumed.task.module.state_dict().values()):
        assert torch.equal(a, b), k
    assert _losses(tmp_path / "parts")[-2:] == _losses(tmp_path / "whole")[-2:]
    again = Trainer(port_up, task(), tmp_path / "parts", TrainerConfig(**cfg))
    again.train(_Loader([batch]))
    assert again.step == 4 and len(_losses(tmp_path / "parts")) == 4


def test_trainer_refuses_what_is_not_ported(tiny_pair, tmp_path):
    """What still raises under parallelism: a mesh the ranks cannot fill
    (JAX's assert), a train batch not divisible by dp (JAX's message) and
    the int8 model under tp (its row scales), the last two on a mesh of two
    ranks' shape in this one process (no collective is reached)."""
    _, port_up = tiny_pair
    task = UtteranceClassificationTask(
        UpstreamDownstreamModel(port_heads.UtteranceLevel(128, 4), 3), 4)
    for dp, tp in ((8, 1), (None, 2)):
        with pytest.raises(AssertionError):
            Trainer(port_up, task, tmp_path, TrainerConfig(dp=dp, tp=tp))
    two = {"dp": Mesh(np.arange(2).reshape(2, 1), ("dp", "tp"), {}, {"dp": 0, "tp": 0}),
           "tp": Mesh(np.arange(2).reshape(1, 2), ("dp", "tp"), {}, {"dp": 0, "tp": 0})}
    trainer = Trainer(port_up, task, tmp_path, TrainerConfig(**TRAIN), mesh=two["dp"])
    trainer.init(resume=False)
    with pytest.raises(ValueError, match="train batch size 3 not divisible by dp=2"):
        trainer.train_step(_batches(1)[0])
    int8 = Wav2Vec2Trunk(Wav2Vec2Config(**TINY), dtype=torch.bfloat16, use_flash=True,
                         quantize=True, device="meta")
    with pytest.raises(ValueError, match="quantize=True cannot take effect under tp > 1"):
        Trainer(Upstream("int8", int8, 3, 128, 320), task, tmp_path, TrainerConfig(**TRAIN),
                mesh=two["tp"])


def test_trainable_upstream_runs_in_train_mode(tiny_pair, tmp_path):
    """upstream_trainable: the upstream in train() on its stock paths,
    under no_grad (the JAX trainer differentiates the probe only, so its
    states need no grad); as in the JAX trainer, only the probe is updated."""
    _, port_up = tiny_pair
    task = UtteranceClassificationTask(
        UpstreamDownstreamModel(port_heads.UtteranceLevel(128, 4, (8,)), 3), 4)
    trainer = Trainer(port_up, task, tmp_path,
                      TrainerConfig(**dict(TRAIN, upstream_trainable=True, total_steps=1)))
    before = {k: v.clone() for k, v in port_up.model.state_dict().items()}
    seen = []
    port_up.model.register_forward_hook(lambda m, i, o: seen.append((m.training,
                                                                     o[0].requires_grad)))
    try:
        trainer.train(_Loader(_batches(1)))
    finally:
        port_up.model._forward_hooks.clear()
        port_up.model.eval()
    assert seen == [(True, False)]
    assert all(torch.equal(before[k], v) for k, v in port_up.model.state_dict().items())
    assert all(p.grad is None for p in port_up.model.parameters())
