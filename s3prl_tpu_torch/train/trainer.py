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
under ``AdamW``'s decay only, as optax's.

Parallelism (the JAX trainer's mesh, s3prl_tpu/train/trainer.py:93-100,
:189-224; one process a device): ``dp`` / ``tp`` (or a ``mesh``, or a
process group of several ranks) build a `parallel.mesh.Mesh`. The upstream
is tp-sharded (`shard_params`), the probe replicated (broadcast from the
first rank). A step's loss is the global batch's, as JAX's GSPMD step
computes it: each rank runs the upstream and the probe on its rows, the
task's loss is taken over the dp-gathered outputs and labels (identical on
every rank: `Task._apply` gathers the module's outputs, `_DpRows`), and the
ranks' gradients are averaged before the clip and the finite guard read
them. The gather hands each rank its rows' gradient times dp
(`collectives.gather_rows_for_loss`), so the mean is the global loss's
gradient also for a parameter the loss reads outside `_apply` (the
AM-softmax weight, GE2E's scale and bias). Dropout draws the global batch's masks and keeps the rank's
rows (`nn.heads.global_rows`), so dp = N repeats dp = 1. `train_step`
takes the global batch and keeps this rank's rows (`shard_batch`; not
divisible by dp raises JAX's message); `train` takes the loader's batches
as the ranks' rows of the global batch (the loader deals them over the dp
axis), each padded to the dp group's longest. Evaluation runs its whole
batch on every rank, as JAX replicates it; logging, TensorBoard and
checkpoints are the leader's. A task that computes its loss without
`Task._apply` (the pretraining tasks, VC, MOS, ST) raises under dp > 1.
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
from ..data.collate import PAD_VALUES
from ..nn.heads import global_rows
from ..parallel import collectives as cl
from ..parallel.distributed import is_leader_process, world_size
from ..parallel.mesh import make_mesh, replicate, shard_batch, shard_params
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
    #: data-parallel ways (None: the ranks left) and tensor-parallel ways over
    #: the process group; dp * tp must equal its ranks (the JAX trainer's)
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


class _DpRows:
    """This dp rank's rows of a step's global batch, set on the task around
    its loss (`Task._apply`): `local` cuts a global per-row tensor to the
    rank's rows, `gather` puts the module's outputs on those rows together
    into the global batch's (autograd: each rank's gradient reaches its own
    rows, times dp: `collectives.gather_rows_for_loss`)."""

    def __init__(self, group, sizes: list, index: int):
        self.group, self.sizes = group, sizes
        self.offset, self.n = sum(sizes[:index]), sizes[index]
        self.applied = False

    def local(self, t):
        return t[self.offset:self.offset + self.n]

    def gather(self, out):
        self.applied = True
        if isinstance(out, torch.Tensor) and out.ndim and out.shape[0] == self.n:
            return cl.gather_rows_for_loss(out, self.group, self.sizes)
        if isinstance(out, (tuple, list)):
            return type(out)(self.gather(o) for o in out)
        if isinstance(out, dict):
            return {k: self.gather(v) for k, v in out.items()}
        return out


def _gather_batch(batch: dict, group, sizes: list) -> dict:
    """The dp group's batches put together (rows in rank order): numeric
    arrays padded on their other axes to the group's longest (with the
    collate's pad value of the key, `data.collate.PAD_VALUES`), the waves
    ``x`` among them (a task may read them: SE / SS), per-row lists through
    ``all_gather_object``."""
    import torch.distributed as dist

    n = sizes[dist.get_rank(group)]
    out = {}
    for key, value in batch.items():
        if isinstance(value, (np.ndarray, torch.Tensor)) and value.ndim and len(value) == n:
            t = torch.as_tensor(value).cpu()
            dims = torch.tensor(t.shape[1:], dtype=torch.int64)
            dims = cl.all_reduce(dims, group, dist.ReduceOp.MAX).tolist()
            pad = torch.full((n, *dims), PAD_VALUES.get(key, 0), dtype=t.dtype)
            pad[(slice(None),) + tuple(slice(0, d) for d in t.shape[1:])] = t
            whole = cl.gather_rows(pad, group, sizes)
            out[key] = whole.numpy() if isinstance(value, np.ndarray) else whole.to(value.device)
        elif isinstance(value, list) and len(value) == n:
            parts = [None] * len(sizes)
            dist.all_gather_object(parts, value, group=group)
            out[key] = [v for part in parts for v in part]
        else:
            out[key] = value
    return out


class Trainer:
    def __init__(self, upstream: Upstream, task, exp_dir, config: TrainerConfig,
                 tb_writer=None, mesh=None):
        self.upstream = upstream
        self.task = task
        self.exp_dir = Path(exp_dir)
        self.exp_dir.mkdir(parents=True, exist_ok=True)
        self.cfg = config
        if mesh is None and (config.dp is not None or config.tp != 1 or world_size() > 1):
            mesh = make_mesh(dp=config.dp, tp=config.tp)
            logger.info(f"trainer mesh from config: {mesh.shape}")
        if mesh is not None and mesh.size("sp") > 1:
            raise NotImplementedError("a trainer mesh with sp > 1: sequence parallelism serves "
                                      "extraction (parallel.mesh.sequence_sharded_extraction)")
        self.mesh = mesh
        if mesh is not None:
            shard_params(mesh, upstream.model)
        self.device = upstream.device
        self.task.module.to(self.device)
        self.optimizer = None
        self.step = 0
        self._best_metric = None
        self._leader = is_leader_process()
        if tb_writer is None and config.tensorboard and self._leader:
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
        if self.mesh is not None:  # the probe replicated, as JAX places it
            replicate(self.mesh, self.task.module)

    @property
    def dp(self) -> int:
        return 1 if self.mesh is None else self.mesh.size("dp")

    def forward_upstream(self, device_batch: dict, train: bool = False):
        """(hs, h_lens) of the batch's waves: frozen unless the upstream is
        trainable and `train`, then in train mode with the dropouts of step
        ``self.step + 1`` (`upstream_generator`)."""
        if not (train and self.cfg.upstream_trainable):
            return self.upstream(device_batch["x"], device_batch["x_len"])
        gen = upstream_generator(self.cfg.seed, self.step + 1, self.device)
        return self.upstream(device_batch["x"], device_batch["x_len"], train=True,
                             generator=gen)

    def _rows(self, n: int) -> _DpRows:
        """This step's `_DpRows` for a local batch of n rows."""
        group = self.mesh.group("dp")
        return _DpRows(group, cl.shard_sizes(n, group), self.mesh.index("dp"))

    def probe_step(self, hs, h_lens, batch: dict, rows: Optional[_DpRows] = None):
        """One training micro-step of the task on the upstream's states:
        (loss, cache, raw gradient norm) as tensors. Under dp (`rows`) hs
        holds this rank's rows and h_lens / batch the global batch's; the
        gradients are averaged over dp (`collectives.all_reduce_grads`)
        before they are read."""
        gen = step_generator(self.cfg.seed, self.step + 1, hs.device)
        if rows is None:
            loss, cache = self.task.loss_and_cache(hs, h_lens, batch, gen, True)
        else:
            self.task.dp_rows = rows
            try:
                with global_rows(rows.offset, rows.n, sum(rows.sizes)):
                    loss, cache = self.task.loss_and_cache(hs, h_lens, batch, gen, True)
            finally:
                self.task.dp_rows = None
            if not rows.applied:
                raise NotImplementedError(
                    f"{type(self.task).__name__} under dp={self.dp}: its loss does not run the "
                    "module through Task._apply, so the global batch's loss cannot be formed")
        loss.backward()
        if rows is not None:
            cl.all_reduce_grads(self.optimizer.params, rows.group)
        grads = [p.grad for p in self.optimizer.params if p.grad is not None]
        grad_norm = global_norm(grads).detach()
        self.optimizer.step()
        post_update = getattr(self.task, "post_update", None)
        if post_update is not None:
            with torch.no_grad():
                post_update()
        return loss.detach(), cache, grad_norm

    def train_step(self, device_batch: dict):
        """The upstream forward and `probe_step` on one global batch (under
        dp this rank's rows of it, `shard_batch`); advances the step counter
        (also when the finite guard skips the update)."""
        if self.dp == 1:
            return self._step(device_batch, device_batch)
        return self._step(shard_batch(self.mesh, device_batch), device_batch)

    def _step(self, local: dict, batch: dict):
        """A step on this rank's rows `local` of the global `batch`."""
        if self.dp == 1:
            hs, h_lens = self.forward_upstream(local, train=True)
            out = self.probe_step(hs, h_lens, batch)
        else:
            rows = self._rows(len(local["x"]))
            with global_rows(rows.offset, rows.n, sum(rows.sizes)):
                hs, h_lens = self.forward_upstream(local, train=True)
            h_lens = cl.gather_rows(h_lens, rows.group, rows.sizes)
            out = self.probe_step(hs, h_lens, batch, rows)
        self.step += 1
        return out

    def _global(self, batch: dict) -> tuple:
        """(local, global) of a loader's batch, this rank's rows of the
        global batch: the waves padded to the dp group's longest
        (all-reduce MAX), the other arrays and the per-row lists put
        together (`_gather_batch`)."""
        if self.dp == 1:
            return batch, batch
        import torch.distributed as dist

        group = self.mesh.group("dp")
        x = batch["x"]
        longest = int(cl.all_reduce(torch.tensor([x.shape[1]]), group, dist.ReduceOp.MAX)[0])
        if longest > x.shape[1]:
            pad = [(0, 0)] * x.ndim
            pad[1] = (0, longest - x.shape[1])
            batch = dict(batch, x=np.pad(np.asarray(x), pad) if isinstance(x, np.ndarray)
                         else torch.nn.functional.pad(x, (0, 0) * (x.ndim - 2)
                                                      + (0, longest - x.shape[1])))
        return batch, _gather_batch(batch, group, cl.shard_sizes(len(batch["x"]), group))

    def _deal_over_dp(self, loader) -> None:
        """A loader dealt over the world's ranks deals over the dp axis:
        the tp ranks of a dp index take the same batches."""
        from ..data.sampler import DistributedBatchSamplerWrapper

        sampler = getattr(loader, "batch_sampler", None)
        if self.mesh is not None and isinstance(sampler, DistributedBatchSamplerWrapper):
            sampler.world_size, sampler.rank = self.dp, self.mesh.index("dp")

    def _log(self, mode: str, logs: Dict[str, float]) -> None:
        if not self._leader:
            return
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
        self._deal_over_dp(train_loader)
        while self.step < cfg.total_steps:
            train_loader.set_epoch(epoch)
            for batch in train_loader:
                if self.step >= cfg.total_steps:
                    break
                local, batch = self._global(batch)
                device, host = _split_batch(batch)
                loss, cache, grad_norm = self._step(_split_batch(local)[0], device)
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
            if self._leader:
                ckpt.mark_valid_best(self.exp_dir, self.step)
            logger.info(f"new valid best {self.task.valid_metric}={metric:.5g}")

    def save(self) -> None:
        """The leader's step directory (every rank holds the same probe)."""
        if not self._leader:
            return
        ckpt.save_checkpoint(
            self.exp_dir,
            self.step,
            self.task.module.state_dict(),
            self.optimizer.state_dict(),
            stats={"best_metric": self._best_metric},
            keep_num_ckpts=self.cfg.keep_num_ckpts,
        )
