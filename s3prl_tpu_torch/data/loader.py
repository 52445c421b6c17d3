"""Minimal data loader: batch sampler + dataset -> collated numpy batches
(port of s3prl_tpu/data/loader.py).

A background prefetch thread decodes and collates the next batches while
the card runs the current step; batches stay numpy until the trainer moves
their numeric arrays to the card. Under a process group of several ranks
each loader deals the batch stream round-robin (`_maybe_distribute`).
"""

from __future__ import annotations

import queue
import threading
from typing import Callable, Optional

from .collate import pad_collate


def _maybe_distribute(batch_sampler, distribute: bool = True):
    """Under a torch.distributed group of several ranks, each rank loads
    only its round-robin share of the batch stream over the world's ranks
    (the reference's `DistributedBatchSamplerWrapper` under DDP,
    s3prl/problem/base.py:445-449); a Trainer on a mesh with tp > 1 deals
    it over the dp axis instead (`Trainer.train`). One process (the common
    case) is a no-op, as is ``distribute=False``."""
    import torch.distributed as dist

    from .sampler import DistributedBatchSamplerWrapper

    if (not distribute or isinstance(batch_sampler, DistributedBatchSamplerWrapper)
            or not (dist.is_available() and dist.is_initialized())
            or dist.get_world_size() <= 1):
        return batch_sampler
    return DistributedBatchSamplerWrapper(batch_sampler, dist.get_world_size(), dist.get_rank())


class DataLoader:
    def __init__(
        self,
        dataset,
        batch_sampler,
        collate_fn: Optional[Callable] = None,
        prefetch: int = 2,
        distribute: bool = True,
    ):
        self.dataset = dataset
        self.batch_sampler = _maybe_distribute(batch_sampler, distribute)
        self.collate_fn = collate_fn or pad_collate
        self.prefetch = prefetch

    def set_epoch(self, epoch: int) -> None:
        if hasattr(self.batch_sampler, "set_epoch"):
            self.batch_sampler.set_epoch(epoch)

    def __len__(self) -> int:
        return len(self.batch_sampler)

    def _produce(self, q: queue.Queue, stop: threading.Event) -> None:
        try:
            for indices in self.batch_sampler:
                if stop.is_set():
                    return
                items = [self.dataset[i] for i in indices]
                q.put(self.collate_fn(items))
            q.put(None)
        except BaseException as e:  # surface worker errors in the consumer
            q.put(e)

    def __iter__(self):
        if self.prefetch <= 0:
            for indices in self.batch_sampler:
                yield self.collate_fn([self.dataset[i] for i in indices])
            return
        q: queue.Queue = queue.Queue(maxsize=self.prefetch)
        stop = threading.Event()
        t = threading.Thread(target=self._produce, args=(q, stop), daemon=True)
        t.start()
        try:
            while True:
                item = q.get()
                if item is None:
                    break
                if isinstance(item, BaseException):
                    raise item
                yield item
        finally:  # a consumer that stops early: unblock the producer and end it
            stop.set()
            while t.is_alive():
                try:
                    q.get_nowait()
                except queue.Empty:
                    pass
                t.join(timeout=0.01)
