"""The training engine (port of s3prl_tpu/train/trainer.py).

One step-based train loop (the reference's legacy downstream Runner,
s3prl/downstream/runner.py:286-419, and the new Problem train loop,
s3prl/problem/base.py:287-553): gradient accumulation, global-norm
clipping, non-finite-gradient skip (`optimizers.Optimizer`), periodic
logging (JSONL; TensorBoard events when ``torch.utils.tensorboard``
imports) and evaluation, directory checkpoints with auto-resume and
valid-best tracking.

A step: the upstream's standardized forward under ``torch.no_grad()``
(`Upstream.__call__`), frozen by default (the model in ``eval()``, so on the
card the kernels serve it) or, with ``upstream_trainable``, in ``train()``
with its dropouts on, as the JAX trainer, which differentiates the probe's
parameters only (s3prl_tpu/train/trainer.py:132-150); then the task's
module in ``train()`` on the states, its loss, ``backward()`` and one
optimizer micro-step. Dropout in a head draws from a ``torch.Generator``
seeded from (seed, step) on the states' device (`step_generator`), the
upstream's from a stream of its own seeded from the same pair
(`upstream_generator`, the JAX trainer's ``k_up, k_task = split(rng)``), so
a resumed run repeats its steps. Evaluation hands the task the generator of
step 0 (the JAX trainer's ``fold_in(key, 0)``), which only a task that
draws in eval reads (VC's prenet).

Pretraining (`problem.pretrain`) keeps that contract: the upstream is the
frozen feature front end (``wav``, ``mel``, ``fbank``, or the distiller's
teacher), and the task owns and trains its model on the batch (its waves
through ``batch["x"]``). A task with a ``post_update()`` (data2vec's EMA
teacher) has it run under ``torch.no_grad()`` after every micro-step, also
one whose update the finite guard skipped or the accumulation held, as the
JAX trainer runs it after ``apply_updates`` (trainer.py:148-158). The
optimizer covers the task's whole module, as the JAX optimizer covers the
whole tree: leaves without a gradient (the EMA teacher; NPC's running
statistics are buffers) are stepped with a zero one, which moves them
under ``AdamW``'s decay only, as optax's. Single device:
``dp`` / ``tp`` other than 1 raise (ROADMAP.md Queue 1 item 10).
"""

from __future__ import annotations

import json
import logging
import time
from dataclasses import dataclass, field
from pathlib import Path
from typing import Dict, List, Optional

import numpy as np
import torch

from . import checkpoint as ckpt
from .optimizers import Optimizer, global_norm
from ..upstream.base import Upstream

logger = logging.getLogger(__name__)


@dataclass
class TrainerConfig:
    total_steps: int = 1000
    log_step: int = 100
    eval_step: int = 500
    save_step: int = 500
    gradient_clipping: float = 1.0
    gradient_accumulate: int = 1
    keep_num_ckpts: int = 2
    seed: int = 1337
    optimizer: dict = field(default_factory=lambda: {"name": "Adam", "lr": 1.0e-4})
    upstream_trainable: bool = False
    tensorboard: bool = True  # event files under exp_dir/tb when tensorboard imports
    #: the JAX package's data / tensor-parallel ways: only one device here
    dp: Optional[int] = None
    tp: int = 1
    #: resume from the newest step dir when one exists (the reference's new
    #: API, problem/base.py:374-421)
    auto_resume: bool = True


def _split_batch(batch: dict):
    """Numeric arrays (numpy or tensors) go to the device; everything else
    stays host-side."""
    device, host = {}, {}
    for k, v in batch.items():
        if isinstance(v, torch.Tensor) or (isinstance(v, np.ndarray) and v.dtype.kind in "fiub"):
            device[k] = v
        else:
            host[k] = v
    return device, host


def step_generator(seed: int, step: int, device) -> torch.Generator:
    """The generator of step `step`'s dropout on `device`."""
    return torch.Generator(device=device).manual_seed((seed << 32 | step) & (2**63 - 1))


def upstream_generator(seed: int, step: int, device) -> torch.Generator:
    """The generator of step `step`'s upstream dropout on `device`: a stream
    apart from `step_generator`'s (bit 62 of the seed set), so the probe's
    draws are the same with the upstream trainable or frozen."""
    return torch.Generator(device=device).manual_seed(
        ((seed << 32 | step) & (2**62 - 1)) | 2**62)


class Trainer:
    def __init__(self, upstream: Upstream, task, exp_dir, config: TrainerConfig,
                 tb_writer=None):
        if config.dp not in (None, 1) or config.tp != 1:
            raise NotImplementedError(
                f"dp={config.dp}, tp={config.tp}: multi-device training is not ported "
                "(ROADMAP.md Queue 1 item 10)")
        self.upstream = upstream
        self.task = task
        self.exp_dir = Path(exp_dir)
        self.exp_dir.mkdir(parents=True, exist_ok=True)
        self.cfg = config
        self.device = upstream.device
        self.task.module.to(self.device)
        self.optimizer = None
        self.step = 0
        self._best_metric = None
        if tb_writer is None and config.tensorboard:
            try:
                from torch.utils.tensorboard import SummaryWriter

                tb_writer = SummaryWriter(log_dir=str(self.exp_dir / "tb"))
            except ImportError as e:  # TB optional: JSONL remains authoritative
                logger.info(f"tensorboard writer unavailable ({e}); JSONL only")
        self._tb = tb_writer
        self._metrics_file = self.exp_dir / "metrics.jsonl"

    # ------------------------------------------------------------------
    def init(self, resume: bool = True) -> None:
        """Initialise (or auto-resume) the module and the optimizer state:
        the module drawn from the seed's generator (the JAX trainer's
        ``fold_in(key(seed), 0)`` init), then the newest complete step
        directory's weights and state when `resume` finds one."""
        self.task.init_params(torch.Generator().manual_seed(self.cfg.seed))
        self.optimizer = Optimizer(
            self.task.module.parameters(), gradient_clipping=self.cfg.gradient_clipping,
            gradient_accumulate=self.cfg.gradient_accumulate,
            total_steps=self.cfg.total_steps, **self.cfg.optimizer)
        if resume:
            latest = ckpt.latest_checkpoint(self.exp_dir)
            if latest is not None:
                model_state, opt_state, stats = ckpt.load_checkpoint(latest, self.device)
                self.task.module.load_state_dict(model_state)
                if opt_state is not None:
                    self.optimizer.load_state_dict(opt_state)
                self.step = int(stats.get("step", 0))
                self._best_metric = stats.get("best_metric")
                logger.info(f"resumed from {latest} at step {self.step}")

    def forward_upstream(self, device_batch: dict, train: bool = False):
        """(hs, h_lens) of the batch's waves: frozen unless the upstream is
        trainable and `train`, then in train mode with the dropouts of step
        ``self.step + 1`` (`upstream_generator`)."""
        if not (train and self.cfg.upstream_trainable):
            return self.upstream(device_batch["x"], device_batch["x_len"])
        gen = upstream_generator(self.cfg.seed, self.step + 1, self.device)
        return self.upstream(device_batch["x"], device_batch["x_len"], train=True,
                             generator=gen)

    def probe_step(self, hs, h_lens, batch: dict):
        """One training micro-step of the task on the upstream's states:
        (loss, cache, raw gradient norm) as tensors."""
        gen = step_generator(self.cfg.seed, self.step + 1, hs.device)
        loss, cache = self.task.loss_and_cache(hs, h_lens, batch, gen, True)
        loss.backward()
        grads = [p.grad for p in self.optimizer.params if p.grad is not None]
        grad_norm = global_norm(grads).detach()
        self.optimizer.step()
        post_update = getattr(self.task, "post_update", None)
        if post_update is not None:
            with torch.no_grad():
                post_update()
        return loss.detach(), cache, grad_norm

    def train_step(self, device_batch: dict):
        """The upstream forward and `probe_step` on one batch; advances
        the step counter (also when the finite guard skips the update)."""
        hs, h_lens = self.forward_upstream(device_batch, train=True)
        out = self.probe_step(hs, h_lens, device_batch)
        self.step += 1
        return out

    def _log(self, mode: str, logs: Dict[str, float]) -> None:
        payload = {"mode": mode, "step": self.step, **logs}
        with open(self._metrics_file, "a") as f:
            f.write(json.dumps(payload) + "\n")
        if self._tb is not None:
            for k, v in logs.items():
                if isinstance(v, (int, float)):
                    self._tb.add_scalar(f"{mode}/{k}", v, self.step)
        logger.info(f"[{mode}] step {self.step}: " + ", ".join(
            f"{k}={v:.5g}" for k, v in logs.items() if isinstance(v, (int, float))))

    def _record(self, cache: dict, host: dict) -> dict:
        record = {k: v.detach().cpu().numpy() for k, v in cache.items()}
        record.update({k: host[k] for k in self.task.host_keys if k in host})
        return record

    # ------------------------------------------------------------------
    def train(self, train_loader, valid_loader=None) -> None:
        cfg = self.cfg
        records: List[dict] = []
        epoch = 0
        t0 = time.time()
        if self.optimizer is None:
            self.init(resume=cfg.auto_resume)
        while self.step < cfg.total_steps:
            train_loader.set_epoch(epoch)
            for batch in train_loader:
                if self.step >= cfg.total_steps:
                    break
                device, host = _split_batch(batch)
                loss, cache, grad_norm = self.train_step(device)
                records.append(self._record(cache, host))

                if self.step % cfg.log_step == 0:
                    logs = self.task.reduction("train", records)
                    logs["grad_norm"] = float(grad_norm)
                    logs["steps_per_sec"] = cfg.log_step / max(time.time() - t0, 1e-9)
                    t0 = time.time()
                    self._log("train", logs)
                    records = []

                if valid_loader is not None and self.step % cfg.eval_step == 0:
                    valid_logs = self.evaluate(valid_loader, "valid")
                    self._maybe_mark_best(valid_logs)

                if self.step % cfg.save_step == 0:
                    self.save()
            epoch += 1
        self.save()

    def evaluate(self, loader, mode: str = "valid") -> Dict[str, float]:
        if self.optimizer is None:
            self.init()
        records = []
        with torch.no_grad():
            for batch in loader:
                device, host = _split_batch(batch)
                hs, h_lens = self.forward_upstream(device)
                gen = step_generator(self.cfg.seed, 0, hs.device)
                _, cache = self.task.loss_and_cache(hs, h_lens, device, gen, False)
                records.append(self._record(cache, host))
        logs = self.task.reduction(mode, records)
        self._log(mode, logs)
        return logs

    def _maybe_mark_best(self, logs: Dict[str, float]) -> None:
        metric = logs.get(self.task.valid_metric)
        if metric is None:
            return
        better = (
            self._best_metric is None
            or (metric > self._best_metric) == self.task.valid_higher_better
        )
        if better and metric != self._best_metric:
            self._best_metric = float(metric)
            self.save()
            ckpt.mark_valid_best(self.exp_dir, self.step)
            logger.info(f"new valid best {self.task.valid_metric}={metric:.5g}")

    def save(self) -> None:
        ckpt.save_checkpoint(
            self.exp_dir,
            self.step,
            self.task.module.state_dict(),
            self.optimizer.state_dict(),
            stats={"best_metric": self._best_metric},
            keep_num_ckpts=self.cfg.keep_num_ckpts,
        )
