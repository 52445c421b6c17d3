"""Label encoders (a copy of s3prl_tpu/data/encoder.py:18-58).

Behavioral spec from the reference's s3prl/dataio/encoder/category.py:11-25.
The tokenizers go with the ASR slice.
"""

from __future__ import annotations

import json
from pathlib import Path
from typing import Iterable, List


class CategoryEncoder:
    """Bijective label <-> id mapping over a sorted category set."""

    def __init__(self, category: Iterable[str]):
        self.category = sorted(set(category))
        self._index = {c: i for i, c in enumerate(self.category)}

    def __len__(self) -> int:
        return len(self.category)

    def encode(self, label: str) -> int:
        return self._index[label]

    def decode(self, index: int) -> str:
        return self.category[index]

    def save(self, path) -> None:
        Path(path).write_text(json.dumps(self.category))

    @classmethod
    def load(cls, path) -> "CategoryEncoder":
        return cls(json.loads(Path(path).read_text()))


class CategoryEncoders:
    """Multiple independent category encoders (multi-label heads, e.g. IC)."""

    def __init__(self, categories: List[Iterable[str]]):
        self.encoders = [CategoryEncoder(c) for c in categories]

    def __len__(self) -> int:
        return sum(len(e) for e in self.encoders)

    def __iter__(self):
        return iter(self.encoders)

    def encode(self, labels: List[str]) -> List[int]:
        return [e.encode(l) for e, l in zip(self.encoders, labels)]

    def decode(self, indices: List[int]) -> List[str]:
        return [e.decode(i) for e, i in zip(self.encoders, indices)]
