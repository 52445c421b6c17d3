"""Task contract (port of s3prl_tpu/task/base.py; the reference's Task base,
s3prl/task/base.py:17-73).

A task owns its trainable module (an ``nn.Module`` over the upstream's
hidden states), defines the per-step loss and a cache of tensors, and a
`reduction` that folds cached step outputs into scalar logs per mode
(train / valid / test). `reduction` runs on the host over records: each
record is the cache as numpy merged with the batch's host-side fields named
in `host_keys`.
"""

from __future__ import annotations

from typing import Any, Dict, List, Optional, Tuple

import numpy as np
import torch
import torch.nn as nn

from ..nn.upstream import init_params


class Task:
    """Base class; subclasses set `module` and implement the hooks."""

    #: module mapping (hs, h_lens, ...) -> task outputs
    module: nn.Module
    #: batch keys that must be carried host-side into reduction records
    host_keys: Tuple[str, ...] = ()

    def init_params(self, generator: Optional[torch.Generator] = None) -> None:
        """flax's initialisation of the module, drawn from `generator`."""
        init_params(self.module, generator)

    def loss_and_cache(
        self, hs: torch.Tensor, h_lens: torch.Tensor, batch: Dict[str, Any],
        generator: Optional[torch.Generator], train: bool
    ) -> Tuple[torch.Tensor, Dict[str, torch.Tensor]]:
        raise NotImplementedError

    def reduction(self, mode: str, records: List[Dict[str, Any]]) -> Dict[str, float]:
        raise NotImplementedError

    # optional: name of the metric used for valid-best tracking + direction
    valid_metric: str = "loss"
    valid_higher_better: bool = False

    #: this dp rank's rows of the step's global batch (the trainer's
    #: `_DpRows`, set around a step's loss under data parallelism): then
    #: `loss_and_cache` is handed this rank's hs with the global batch's
    #: h_lens and labels, and `_apply` gives the global batch's outputs
    dp_rows = None

    def _apply(self, hs, h_lens, generator, train: bool):
        """The module in train or eval mode on (hs, h_lens). Under `dp_rows`
        the module runs on this rank's rows (h_lens cut to them) and its
        outputs come back dp-gathered: the loss over them is the global
        batch's on every rank."""
        if self.module.training != train:
            self.module.train(train)
        rows = self.dp_rows
        if rows is None:
            return self.module(hs, h_lens, generator=generator if train else None)
        return rows.gather(self.module(hs, rows.local(h_lens),
                                       generator=generator if train else None))


def device_labels(batch: Dict[str, Any], key: str, device) -> torch.Tensor:
    """An int label array of the batch as an int64 tensor on `device`."""
    return torch.as_tensor(np.asarray(batch[key]), device=device).long()
