"""Batch samplers (a copy of s3prl_tpu/data/sampler.py).

Behavioral spec from the reference's s3prl/dataio/sampler/: six batch
samplers + a distributed wrapper, all epoch-aware via `set_epoch`
(dataio/sampler/__init__.py:1-21). A batch sampler yields lists of dataset
indices; shuffling is seeded by epoch for exact resume reproducibility.

TPU note: `SortedBucketingSampler` is the main tool — batching
similar-length utterances minimizes padded compute under static-shape
bucketing (the reference uses it for the same reason on GPUs,
sorted_sampler.py:20-116).
"""

from __future__ import annotations

import math
from typing import Iterator, List, Optional, Sequence

import numpy as np


class _EpochAware:
    def __init__(self):
        self.epoch = 0

    def set_epoch(self, epoch: int) -> None:
        self.epoch = epoch

    def _rng(self, seed: int = 12345) -> np.random.RandomState:
        return np.random.RandomState(seed + self.epoch)


class FixedBatchSizeBatchSampler(_EpochAware):
    """Plain fixed-size batching with optional shuffling."""

    def __init__(self, data_len: int, batch_size: int, shuffle: bool = False, seed: int = 12345):
        super().__init__()
        self.data_len = data_len
        self.batch_size = batch_size
        self.shuffle = shuffle
        self.seed = seed

    def __iter__(self) -> Iterator[List[int]]:
        order = np.arange(self.data_len)
        if self.shuffle:
            self._rng(self.seed).shuffle(order)
        for i in range(0, self.data_len, self.batch_size):
            yield order[i : i + self.batch_size].tolist()

    def __len__(self) -> int:
        return math.ceil(self.data_len / self.batch_size)


class SortedBucketingSampler(_EpochAware):
    """Length-sorted bucketing (reference: sorted_sampler.py:20-70).

    Sorts by descending length, slices fixed-size batches (halving the batch
    for buckets whose max length exceeds `max_length`), then shuffles the
    batch order per epoch.
    """

    def __init__(
        self,
        lengths: Sequence[int],
        batch_size: int,
        max_length: int = 300000,
        shuffle: bool = False,
        seed: int = 12345,
    ):
        super().__init__()
        self.lengths = np.asarray(lengths)
        self.batch_size = batch_size
        self.max_length = max_length
        self.shuffle = shuffle
        self.seed = seed
        order = np.argsort(-self.lengths)  # descending
        self.batches: List[List[int]] = []
        i = 0
        while i < len(order):
            size = self.batch_size
            if self.lengths[order[i]] > self.max_length:
                size = max(self.batch_size // 2, 1)
            self.batches.append(order[i : i + size].tolist())
            i += size

    def __iter__(self) -> Iterator[List[int]]:
        idx = np.arange(len(self.batches))
        if self.shuffle:
            self._rng(self.seed).shuffle(idx)
        for i in idx:
            yield self.batches[i]

    def __len__(self) -> int:
        return len(self.batches)


class SortedSliceSampler(_EpochAware):
    """Random anchor + length-neighborhood slices (reference:
    sorted_sampler.py:72-116): per epoch, sample anchors and take the
    following `batch_size` items in the sorted order."""

    def __init__(
        self,
        lengths: Sequence[int],
        batch_size: int,
        max_length: int = 300000,
        seed: int = 12345,
    ):
        super().__init__()
        self.lengths = np.asarray(lengths)
        self.batch_size = batch_size
        self.max_length = max_length
        self.seed = seed
        self.order = np.argsort(-self.lengths)

    def __iter__(self) -> Iterator[List[int]]:
        rng = self._rng(self.seed)
        n = len(self.order)
        n_batches = math.ceil(n / self.batch_size)
        starts = rng.randint(0, n, size=n_batches)
        for s in starts:
            size = self.batch_size
            if self.lengths[self.order[s]] > self.max_length:
                size = max(self.batch_size // 2, 1)
            yield self.order[s : s + size].tolist() or [int(self.order[-1])]

    def __len__(self) -> int:
        return math.ceil(len(self.order) / self.batch_size)


class MaxTimestampBatchSampler(_EpochAware):
    """Token-budget batching (reference: max_timestamp_batch_sampler.py:17):
    greedily pack length-sorted utterances while batch_frames = max_len *
    batch_count stays under the budget."""

    def __init__(
        self,
        lengths: Sequence[int],
        max_timestamp: int,
        shuffle: bool = False,
        seed: int = 12345,
        reduce_factor: int = 1,
    ):
        super().__init__()
        self.lengths = np.asarray(lengths)
        self.max_timestamp = max_timestamp // max(reduce_factor, 1)
        self.shuffle = shuffle
        self.seed = seed
        order = np.argsort(-self.lengths)
        self.batches = []
        cur: List[int] = []
        cur_max = 0
        for i in order:
            new_max = max(cur_max, int(self.lengths[i]))
            if cur and new_max * (len(cur) + 1) > self.max_timestamp:
                self.batches.append(cur)
                cur, cur_max = [], 0
                new_max = int(self.lengths[i])
            cur.append(int(i))
            cur_max = new_max
        if cur:
            self.batches.append(cur)

    def __iter__(self) -> Iterator[List[int]]:
        idx = np.arange(len(self.batches))
        if self.shuffle:
            self._rng(self.seed).shuffle(idx)
        for i in idx:
            yield self.batches[i]

    def __len__(self) -> int:
        return len(self.batches)


class BalancedWeightedSampler(_EpochAware):
    """Class-rebalancing sampler (reference: balanced_weighted_sampler.py):
    sample with replacement, inversely proportional to class frequency."""

    def __init__(
        self,
        labels: Sequence[str],
        batch_size: int,
        duplicate: int = 1,
        seed: int = 12345,
    ):
        super().__init__()
        self.labels = list(labels)
        self.batch_size = batch_size
        self.seed = seed
        counts = {}
        for l in self.labels:
            counts[l] = counts.get(l, 0) + 1
        weights = np.asarray([1.0 / counts[l] for l in self.labels])
        self.probs = weights / weights.sum()
        self.num_samples = len(self.labels) * duplicate

    def __iter__(self) -> Iterator[List[int]]:
        rng = self._rng(self.seed)
        sampled = rng.choice(len(self.labels), size=self.num_samples, p=self.probs)
        for i in range(0, self.num_samples, self.batch_size):
            yield sampled[i : i + self.batch_size].tolist()

    def __len__(self) -> int:
        return math.ceil(self.num_samples / self.batch_size)


class GroupSameItemSampler(_EpochAware):
    """One batch per group key (reference: group_same_item_sampler.py, used
    by diarization to keep all chunks of a recording together)."""

    def __init__(self, group_ids: Sequence):
        super().__init__()
        groups = {}
        for i, g in enumerate(group_ids):
            groups.setdefault(g, []).append(i)
        self.batches = list(groups.values())

    def __iter__(self) -> Iterator[List[int]]:
        return iter(self.batches)

    def __len__(self) -> int:
        return len(self.batches)


class DistributedBatchSamplerWrapper(_EpochAware):
    """Shard ANY batch sampler across data-parallel workers.

    Semantics follow the reference (distributed_sampler.py:23-120): batches
    are dealt round-robin by rank; when the batch count is not divisible by
    world_size, trailing batches are split in half to make it so (allowing
    duplicates only if unavoidable), so every rank sees the same number of
    steps — a requirement for lockstep SPMD training.
    """

    def __init__(self, sampler, world_size: int, rank: int, allow_duplicates: bool = True):
        super().__init__()
        assert 0 <= rank < world_size
        self.sampler = sampler
        self.world_size = world_size
        self.rank = rank
        self.allow_duplicates = allow_duplicates

    def set_epoch(self, epoch: int) -> None:
        super().set_epoch(epoch)
        if hasattr(self.sampler, "set_epoch"):
            self.sampler.set_epoch(epoch)

    def _even_batches(self) -> List[List[int]]:
        batches = [list(b) for b in self.sampler]
        remainder = len(batches) % self.world_size
        if remainder == 0:
            return batches
        # split the largest splittable batches in half until divisible
        need = self.world_size - remainder
        out = list(batches)
        i = 0
        while need > 0 and i < len(out):
            if len(out[i]) >= 2:
                half = len(out[i]) // 2
                out.insert(i + 1, out[i][half:])
                out[i] = out[i][:half]
                need -= 1
                i += 2
            else:
                i += 1
        while need > 0:  # unavoidable: duplicate batches
            if not self.allow_duplicates:
                raise RuntimeError("cannot make batch count divisible without duplicates")
            out.append(list(out[need % len(out)]))
            need -= 1
        return out

    def __iter__(self) -> Iterator[List[int]]:
        batches = self._even_batches()
        for i in range(self.rank, len(batches), self.world_size):
            yield batches[i]

    def __len__(self) -> int:
        n = len(self.sampler)
        return math.ceil(n / self.world_size)


class GE2EBatchSampler(_EpochAware):
    """Speaker-grouped batches for the GE2E loss (reference: downstream/
    voxceleb2_ge2e/dataset.py:57-130): each batch is `speakers_per_batch`
    speakers x `utts_per_speaker` consecutive utterances of each speaker,
    flattened speaker-major so the task can reshape to [N, M, D]."""

    def __init__(
        self,
        labels: Sequence[str],
        speakers_per_batch: int = 10,
        utts_per_speaker: int = 10,
        batches_per_epoch: Optional[int] = None,
        seed: int = 12345,
    ):
        super().__init__()
        self.by_speaker = {}
        for i, lab in enumerate(labels):
            self.by_speaker.setdefault(str(lab), []).append(i)
        if len(self.by_speaker) < speakers_per_batch:
            raise ValueError(
                f"need >= {speakers_per_batch} speakers, got {len(self.by_speaker)}")
        self.speakers = sorted(self.by_speaker)
        self.speakers_per_batch = speakers_per_batch
        self.utts_per_speaker = utts_per_speaker
        self.batches_per_epoch = batches_per_epoch or max(
            len(labels) // (speakers_per_batch * utts_per_speaker), 1)
        self.seed = seed

    def __iter__(self) -> Iterator[List[int]]:
        rng = self._rng(self.seed)
        for _ in range(self.batches_per_epoch):
            spks = rng.choice(len(self.speakers), self.speakers_per_batch,
                              replace=False)
            batch: List[int] = []
            for s in spks:
                pool = self.by_speaker[self.speakers[s]]
                take = rng.choice(len(pool), self.utts_per_speaker,
                                  replace=len(pool) < self.utts_per_speaker)
                batch.extend(pool[j] for j in take)
            yield batch

    def __len__(self) -> int:
        return self.batches_per_epoch
