"""The multi-process runtime (port of s3prl_tpu/parallel/distributed.py).

One process a device, as the reference's DDP runs (run_downstream.py:
166-168): `initialize` starts the ``torch.distributed`` group (the twin of
``jax.distributed.initialize``), `is_leader_process` gates side effects on
rank 0 (utility/helper.py:28) and `barrier` syncs the group (the
rank-0-downloads pattern, runner.py:145-156). `spawn` starts a group of
ranks on one host (the tests, ``dryrun_multichip`` and ``chip_smoke.py``);
``torchrun`` starts one across cards.
"""

from __future__ import annotations

import logging
import os
import tempfile
from typing import Callable, Optional

import torch
import torch.distributed as dist

logger = logging.getLogger(__name__)


def _initialized() -> bool:
    return dist.is_available() and dist.is_initialized()


def world_size() -> int:
    """The ranks of the default group; 1 without one."""
    return dist.get_world_size() if _initialized() else 1


def rank() -> int:
    """This process's rank in the default group; 0 without one."""
    return dist.get_rank() if _initialized() else 0


def initialize(coordinator_address: Optional[str] = None, num_processes: Optional[int] = None,
               process_id: Optional[int] = None, backend: Optional[str] = None) -> None:
    """Starts the process group; a no-op in one process with no ``RANK`` /
    ``WORLD_SIZE`` in the environment and no arguments (as the JAX one
    without a coordinator), or when a group already runs.

    `coordinator_address` is an init method (``tcp://host:port``,
    ``file:///path``; default ``env://``, which ``torchrun`` fills),
    `num_processes` the world size and `process_id` this rank (default:
    the environment's). The backend is NCCL when CUDA is available and
    every rank of this host has a card of its own (``LOCAL_WORLD_SIZE`` <=
    the device count; each rank then takes card ``LOCAL_RANK``), gloo
    otherwise; `backend` wins. A group that fails to start raises."""
    if _initialized():
        return
    env = os.environ
    if (coordinator_address is None and num_processes is None
            and "RANK" not in env and "WORLD_SIZE" not in env):
        logger.info("single-process runtime; no torch.distributed group")
        return
    size = int(num_processes if num_processes is not None else env["WORLD_SIZE"])
    me = int(process_id if process_id is not None else env["RANK"])
    local_size = int(env.get("LOCAL_WORLD_SIZE", size))
    if backend is None:
        own_cards = torch.cuda.is_available() and local_size <= torch.cuda.device_count()
        backend = "nccl" if own_cards else "gloo"
    if backend == "nccl":
        torch.cuda.set_device(int(env.get("LOCAL_RANK", me % max(local_size, 1))))
    dist.init_process_group(backend, init_method=coordinator_address or "env://",
                            world_size=size, rank=me)
    logger.info(f"initialized rank {me}/{size} ({backend})")


def is_leader_process() -> bool:
    """Rank 0, or True without a group (utility/helper.py:28)."""
    return rank() == 0


def barrier(name: str = "barrier") -> None:
    """Syncs the group (no-op without one); `name` is for the log."""
    if _initialized():
        logger.debug(f"barrier {name}")
        dist.barrier()


def _rank_main(index: int, fn: Callable, nprocs: int, store: str, out_dir: str,
               backend: str, threads: Optional[int], args: tuple) -> None:
    if threads is not None:
        torch.set_num_threads(threads)
    initialize(f"file://{store}", nprocs, index, backend)
    try:
        result = fn(*args)
        torch.save(result, os.path.join(out_dir, f"rank{index}.pt"))
    finally:
        dist.destroy_process_group()


def spawn(fn: Callable, nprocs: int, *args, backend: str = "gloo", threads: Optional[int] = None,
          tmp_dir: Optional[str] = None) -> list:
    """Runs ``fn(*args)`` in `nprocs` new processes joined in one group
    (`backend`, a ``file://`` store in a temporary directory under
    `tmp_dir`) and returns each rank's result in rank order (saved with
    ``torch.save``). `fn` must be importable by name; `threads` sets each
    rank's ``torch.set_num_threads``. A rank that raises ends the run with
    an exception naming it; every process is joined before this returns."""
    import torch.multiprocessing as mp

    with tempfile.TemporaryDirectory(dir=tmp_dir) as tmp:
        store = os.path.join(tmp, "store")
        mp.start_processes(_rank_main, args=(fn, nprocs, store, tmp, backend, threads, args),
                           nprocs=nprocs, join=True, start_method="spawn")
        return [torch.load(os.path.join(tmp, f"rank{i}.pt"), weights_only=False)
                for i in range(nprocs)]
