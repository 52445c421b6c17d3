"""Learned QbE recipes (port of s3prl_tpu/problem/qbe_embedding.py; the
legacy downstream/quesst14_embedding + sws2013).

Config spec: quesst14_embedding/config.yaml - AdamW 1e-5, 50k steps,
batch 16, bottleneck 256 / hidden 1024 / 2 LSTM layers; sws2013/config.yaml
- 25k steps, margin -1.0. Training pairs come from the benchmark RTTMs
(quesst14_trainset.py:22-50: positives from quesst14_<split>.rttm, negatives
sampled from the complement); evaluation embeds every test pair and reports
the loss and the pairs' retrieval AUC (the official ATWV/MTWV scoring runs
in the benchmark's external toolkit). A batch holds its queries then its
documents, padded together into one 1-s bucket of at most 30 s. The
recipes' default upstream is ``fbank``; a run may name a trunk entry in
``build_upstream``.
"""

from __future__ import annotations

import logging
from pathlib import Path

import numpy as np
import pandas as pd
import yaml

from .common import CommonProblem
from ..data.audio import load_wav
from ..data.collate import Buckets
from ..data.loader import DataLoader
from ..data.sampler import FixedBatchSizeBatchSampler
from ..nn.upstream import SUpstream
from ..task.qbe_embedding import QbeEmbedder, QbeEmbeddingTask
from ..train import checkpoint as ckpt
from ..train.trainer import Trainer, TrainerConfig

logger = logging.getLogger(__name__)


class _PairDataset:
    """pairs.csv rows: query_path, doc_path, pair_label (+1/-1)."""

    def __init__(self, csv_path, sample_rate: int = 16000):
        self.df = pd.read_csv(csv_path)
        self.sample_rate = sample_rate

    def __len__(self):
        return len(self.df)

    @property
    def lengths(self):
        return [int(16000 * 2)] * len(self.df)

    def __getitem__(self, i):
        row = self.df.iloc[i]
        q, _ = load_wav(row["query_path"], self.sample_rate)
        d, _ = load_wav(row["doc_path"], self.sample_rate)
        return {
            "query": q.astype(np.float32),
            "doc": d.astype(np.float32),
            "pair_label": int(row["pair_label"]),
            "unique_name": str(row.get("id", i)),
        }


def _pair_collate(items, buckets=None):
    """Queries then documents in one padded batch; 'pair_label' repeated
    for the documents."""
    wavs = [it["query"] for it in items] + [it["doc"] for it in items]
    lens = np.asarray([len(w) for w in wavs], np.int32)
    target = buckets.fit(int(lens.max())) if buckets is not None else int(lens.max())
    x = np.zeros((len(wavs), target), np.float32)
    for i, w in enumerate(wavs):
        x[i, : len(w)] = w[:target]
    labels = [it["pair_label"] for it in items]
    return {
        "x": x,
        "x_len": np.minimum(lens, target),
        "pair_label": np.asarray(labels + labels, np.int32),
        "unique_name": [it["unique_name"] for it in items],
    }


class QbeEmbeddingQuesst14(CommonProblem):
    """Legacy downstream/quesst14_embedding."""

    STAGES = ["prepare_data", "train_stage", "evaluate_stage"]

    def default_config(self) -> dict:
        return {
            "target_dir": "???",
            "prepare_data": {"quesst2014_root": "???", "negatives_per_query": 5},
            "build_upstream": {"name": "fbank"},
            "build_downstream": {"bottleneck_dim": 256, "hidden_dim": 1024,
                                 "num_layers": 2},
            "build_task": {"margin": 0.0},
            "build_batch_sampler": {"batch_size": 16},
            "build_optimizer": {"name": "AdamW", "lr": 1.0e-5},
            "train": {
                "total_steps": 50000, "log_step": 500, "eval_step": 5000,
                "save_step": 5000,
            },
        }

    def prepare_data(self, workspace: Path, config: dict):
        """quesst14Database layout (quesst14_trainset.py:15-50):
        dev_queries/*.wav + Audio/*.wav + scoring/quesst14_dev.rttm with
        'utt <query>.<doc>' positive rows."""
        cfg = config["prepare_data"]
        root = Path(cfg["quesst2014_root"])
        rng = np.random.RandomState(0)
        audio = {p.stem: p for p in sorted((root / "Audio").glob("*.wav"))}
        for split, qdir in [("train", "dev_queries"), ("test", "eval_queries")]:
            rttm = root / "scoring" / f"quesst14_{'dev' if split == 'train' else 'eval'}.rttm"
            if not rttm.exists():
                continue
            positives: dict = {}
            for line in rttm.read_text().splitlines():
                parts = line.split()
                if len(parts) >= 2 and parts[0] == "LEXEME":
                    positives.setdefault(parts[1], set()).add(parts[5])
            rows = []
            names = sorted(audio)
            for qp in sorted((root / qdir).glob("*.wav")):
                pos = positives.get(qp.stem, set()) & set(names)
                for doc in sorted(pos):
                    rows.append(dict(id=f"{qp.stem}+{doc}", query_path=str(qp),
                                     doc_path=str(audio[doc]), pair_label=1))
                negs = [n for n in names if n not in pos]
                for j in rng.choice(len(negs), min(cfg.get("negatives_per_query", 5),
                                                   len(negs)), replace=False):
                    rows.append(dict(id=f"{qp.stem}-{negs[j]}", query_path=str(qp),
                                     doc_path=str(audio[negs[j]]), pair_label=-1))
            pd.DataFrame(rows).to_csv(workspace / f"{split}.csv", index=False)

    def build_task(self, upstream: SUpstream, config: dict):
        module = QbeEmbedder(upstream.num_layers, upstream.hidden_sizes[-1],
                             **config.get("build_downstream", {}))
        return QbeEmbeddingTask(module, **config.get("build_task", {}))

    def _loader(self, workspace, csv_name, encoder, mode, config):
        csv_path = workspace / csv_name
        if not csv_path.exists():
            return None
        ds = _PairDataset(csv_path)
        sampler = FixedBatchSizeBatchSampler(
            len(ds), config.get("build_batch_sampler", {}).get("batch_size", 16),
            shuffle=(mode == "train"))
        buckets = Buckets.linear(16000, 16000 * 30)
        return DataLoader(ds, sampler, lambda items: _pair_collate(items, buckets),
                          distribute=mode == "train")

    def _trainer(self, workspace: Path, config: dict):
        """(trainer, no encoder): CommonProblem's train stage runs on it,
        with the pair loader."""
        upstream = self.build_upstream(**config.get("build_upstream", {}))
        task = self.build_task(upstream, config)
        trainer = Trainer(
            upstream.upstream, task, workspace / "train",
            TrainerConfig(optimizer=config.get("build_optimizer", {"name": "AdamW", "lr": 1e-5}),
                          **config.get("train", {})),
        )
        return trainer, None

    def evaluate_stage(self, workspace: Path, config: dict):
        trainer, _ = self._trainer(workspace, config)
        loader = self._loader(workspace, "test.csv", None, "test", config)
        trainer.init(resume=False)
        best = workspace / "train" / "valid_best"
        load_dir = best if best.exists() else ckpt.latest_checkpoint(workspace / "train")
        if load_dir is not None:
            trainer.task.module.load_state_dict(ckpt.load_checkpoint(load_dir, trainer.device)[0])
        logs = trainer.evaluate(loader, mode="test-test")
        with open(workspace / "result.yaml", "w") as f:
            yaml.safe_dump({"test": logs}, f)
        return {"test": logs}


class Sws2013Embedding(QbeEmbeddingQuesst14):
    """Legacy downstream/sws2013: 25k steps, cosine margin -1."""

    def default_config(self) -> dict:
        cfg = super().default_config()
        cfg["prepare_data"] = {"sws2013_root": "???", "negatives_per_query": 5}
        cfg["build_downstream"] = {"bottleneck_dim": 256, "hidden_dim": 1024,
                                   "num_layers": 2}
        cfg["build_task"] = {"margin": -1.0}
        cfg["train"]["total_steps"] = 25000
        return cfg


class QbeEmbeddingExample(QbeEmbeddingQuesst14):
    """Smoke test: tone queries matching same-tone docs."""

    def default_config(self) -> dict:
        cfg = super().default_config()
        cfg["prepare_data"] = {"num": 6}
        cfg["build_downstream"] = {"bottleneck_dim": 32, "hidden_dim": 32,
                                   "num_layers": 1}
        cfg["build_batch_sampler"] = {"batch_size": 2}
        cfg["train"] = {"total_steps": 4, "log_step": 2, "eval_step": 2,
                        "save_step": 2}
        return cfg

    def prepare_data(self, workspace: Path, config: dict):
        from ..util.pseudo_data import _write_wav

        rng = np.random.RandomState(0)
        (workspace / "wavs").mkdir(parents=True, exist_ok=True)

        def tone(f0, secs):
            t = np.arange(int(16000 * secs)) / 16000.0
            return (np.sin(2 * np.pi * f0 * t) * 0.3
                    + rng.randn(len(t)) * 0.05).astype(np.float32)

        for split, n in [("train", config["prepare_data"].get("num", 6)),
                         ("test", 4)]:
            rows = []
            for i in range(n):
                f0 = 300.0 * (1.5 ** (i % 2))
                qp = workspace / "wavs" / f"{split}_q{i}.wav"
                dp = workspace / "wavs" / f"{split}_d{i}.wav"
                _write_wav(qp, tone(f0, 0.5))
                label = 1 if i % 2 == 0 else -1
                _write_wav(dp, tone(f0 if label > 0 else f0 * 1.7, 0.8))
                rows.append(dict(id=f"{split}_{i}", query_path=str(qp),
                                 doc_path=str(dp), pair_label=label))
            pd.DataFrame(rows).to_csv(workspace / f"{split}.csv", index=False)
