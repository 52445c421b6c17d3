"""Minimal data loader: batch sampler + dataset -> collated numpy batches
(port of s3prl_tpu/data/loader.py).

A background prefetch thread decodes and collates the next batches while
the card runs the current step; batches stay numpy until the trainer moves
their numeric arrays to the card. Single-process only: multi-process data
parallelism is not ported (ROADMAP.md Queue 1 item 10).
"""

from __future__ import annotations

import queue
import threading
from typing import Callable, Optional

from .collate import pad_collate


def _single_process(batch_sampler):
    """The JAX loader hands each process its share of the batches under
    multi-host SPMD (`_maybe_distribute`); the port runs one process, and
    refuses a process group of several."""
    import torch.distributed as dist

    if dist.is_available() and dist.is_initialized() and dist.get_world_size() > 1:
        raise NotImplementedError(
            f"a torch.distributed group of {dist.get_world_size()} processes: distributed "
            "data loading is not ported (ROADMAP.md Queue 1 item 10)")
    return batch_sampler


class DataLoader:
    def __init__(
        self,
        dataset,
        batch_sampler,
        collate_fn: Optional[Callable] = None,
        prefetch: int = 2,
    ):
        self.dataset = dataset
        self.batch_sampler = _single_process(batch_sampler)
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
