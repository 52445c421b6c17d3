"""Optimizers + LR schedules (port of s3prl_tpu/train/optimizers.py, whose
`build_optimizer` keywords `Optimizer` takes).

The JAX package's transform is ``optax.MultiSteps(optax.apply_if_finite(
optax.chain(optax.clip_by_global_norm(c), core), 100), k)``, folding the
reference runner's training hygiene (s3prl/downstream/runner.py:313-354)
around the reference's optimizers (s3prl/optimizers.py:19) and schedule
(s3prl/schedulers.py:12). `Optimizer` is that chain around
``torch.optim.Adam`` / ``AdamW`` / ``SGD``, rule for rule:

- accumulation (``MultiSteps``): the running mean ``acc + (g - acc) / (i +
  1)`` of k micro-gradients, handed on once every k calls;
- the finite guard (``apply_if_finite``): an update whose gradient holds a
  NaN or an Inf changes neither the parameters nor the core's moments or
  step count; after more than `max_consecutive_errors` of them in a row it
  is applied anyway;
- clipping (``clip_by_global_norm``): every gradient becomes ``(g / norm) *
  c`` when the global norm is at least c, with no epsilon (not
  ``clip_grad_norm_``'s ``c / (norm + 1e-6)``);
- the schedule: update i (counting applied updates from 0) takes the
  learning rate ``schedule(i)``, so the first warm-up update has lr 0.
"""

from __future__ import annotations

from typing import Callable, Iterable, List, Optional

import torch


def _linear(init: float, end: float, steps: int, count: int) -> float:
    """``optax.linear_schedule(init, end, steps)(count)``."""
    frac = 1.0 - min(max(count, 0), steps) / steps
    return (init - end) * frac + end


def build_scheduler(
    name: Optional[str],
    lr: float,
    total_steps: int,
    warmup_proportion: float = 0.07,
) -> Callable[[int], float]:
    """update index -> lr. None: constant lr; 'linear_schedule' mirrors
    schedulers.py:12 (optax.join_schedules of a warm-up from 0 and a decay
    to 0)."""
    if not name:
        return lambda count: lr
    if name == "linear_schedule":
        warmup = max(int(total_steps * warmup_proportion), 1)
        decay = max(total_steps - warmup, 1)
        return lambda count: (_linear(0.0, lr, warmup, count) if count < warmup
                              else _linear(lr, 0.0, decay, count - warmup))
    raise ValueError(f"unknown scheduler {name}")


def global_norm(tensors: Iterable[torch.Tensor]) -> torch.Tensor:
    """optax.global_norm: sqrt of the sum of squares of every element."""
    return torch.sqrt(sum(torch.sum(t.float() ** 2) for t in tensors))


class Optimizer:
    """The JAX trainer's optax chain over a torch optimizer. Call `step()`
    once per micro-batch, after ``backward()``: it reads each parameter's
    ``.grad`` (zero where None) and clears it."""

    def __init__(
        self,
        params: Iterable[torch.nn.Parameter],
        name: str = "Adam",
        lr: float = 1.0e-4,
        total_steps: int = 200000,
        scheduler: Optional[str] = None,
        warmup_proportion: float = 0.07,
        weight_decay: float = 0.01,
        gradient_clipping: float = 1.0,
        gradient_accumulate: int = 1,
        eps: float = 1.0e-8,
        max_consecutive_errors: int = 100,
    ):
        self.params: List[torch.nn.Parameter] = [p for p in params if p.requires_grad]
        self.schedule = build_scheduler(scheduler, lr, total_steps, warmup_proportion)
        if name in ("Adam", "adam"):
            self.core = torch.optim.Adam(self.params, lr=lr, eps=eps)
        elif name in ("AdamW", "adamw"):
            self.core = torch.optim.AdamW(self.params, lr=lr, eps=eps, weight_decay=weight_decay)
        elif name in ("sgd", "SGD"):
            self.core = torch.optim.SGD(self.params, lr=lr)
        else:
            raise ValueError(f"unknown optimizer {name}")
        self.max_norm = gradient_clipping
        self.k = gradient_accumulate
        self.max_consecutive_errors = max_consecutive_errors
        self.count = 0  # updates applied: the schedule's step
        self.notfinite_count = 0
        self.mini_step = 0
        self.acc: Optional[List[torch.Tensor]] = None

    def step(self) -> bool:
        """One micro-step; True when it changed the parameters."""
        grads = [torch.zeros_like(p) if p.grad is None else p.grad for p in self.params]
        for p in self.params:
            p.grad = None
        if self.k > 1:
            if self.acc is None:
                self.acc = [torch.zeros_like(g) for g in grads]
            for a, g in zip(self.acc, grads):
                a.add_((g - a) / (self.mini_step + 1))
            self.mini_step += 1
            if self.mini_step < self.k:
                return False
            self.mini_step = 0
            grads, self.acc = self.acc, None
        finite = bool(torch.stack([torch.isfinite(g).all() for g in grads]).all())
        self.notfinite_count = 0 if finite else self.notfinite_count + 1
        if not (finite or self.notfinite_count > self.max_consecutive_errors):
            return False
        norm = global_norm(grads)
        for p, g in zip(self.params, grads):
            p.grad = torch.where(norm < self.max_norm, g, (g / norm) * self.max_norm)
        for group in self.core.param_groups:
            group["lr"] = self.schedule(self.count)
        self.core.step()
        for p in self.params:
            p.grad = None
        self.count += 1
        return True

    def state_dict(self) -> dict:
        return {"core": self.core.state_dict(), "count": self.count,
                "notfinite_count": self.notfinite_count, "mini_step": self.mini_step,
                "acc": self.acc}

    def load_state_dict(self, state: dict) -> None:
        self.core.load_state_dict(state["core"])
        self.count, self.notfinite_count = state["count"], state["notfinite_count"]
        self.mini_step, self.acc = state["mini_step"], state["acc"]
        if self.acc is not None:
            self.acc = [a.to(p.device) for a, p in zip(self.acc, self.params)]

