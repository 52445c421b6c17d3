"""MOS prediction problem (port of s3prl_tpu/problem/mos.py; the reference's
downstream/mos_prediction).

Behavioral spec (downstream/mos_prediction/config.yaml + expert.py): VCC2018
listener ratings, Adam lr 1e-4, 20k steps, gradient accumulation 2, train
batch 8; model projector_dim 256 with clipping + attention pooling and
segment/bias loss weights 1/1; evaluation reports utterance- and
system-level MSE / LCC / SRCC.

Train CSVs carry one row per (wav, judge) rating: columns
id, wav_path, mean (per-wav average score), mos (this judge's score),
judge_id (int), system_name. Test CSVs need one row per wav (mean only).
The loaders pad to 1-s buckets of at most 30 s, as in the JAX package. The
recipes' default upstream is ``fbank``; a run may name a trunk entry in
``build_upstream``.
"""

from __future__ import annotations

import logging
from pathlib import Path

import numpy as np
import pandas as pd

from .common import CommonProblem
from ..data.collate import Buckets, pad_collate
from ..data.dataset import _CsvDataset
from ..data.loader import DataLoader
from ..data.sampler import FixedBatchSizeBatchSampler
from ..nn.upstream import SUpstream
from ..task.mos_prediction import MosDownstreamModule, MosPredictionTask
from ..train.trainer import Trainer, TrainerConfig

logger = logging.getLogger(__name__)


class MosRatingDataset(_CsvDataset):
    def __getitem__(self, i: int) -> dict:
        row = self.df.iloc[i]
        return {
            "x": self._load_wav(row),
            "mean": np.float32(row["mean"]),
            "mos": np.float32(row.get("mos", row["mean"])),
            "judge_id": int(row.get("judge_id", 0)),
            "system_name": str(row.get("system_name", "sys0")),
            "unique_name": str(row["id"]),
        }


class MosPrediction(CommonProblem):
    """VCC2018 MOS prediction (legacy downstream/mos_prediction)."""

    STAGES = ["prepare_data", "train_stage", "evaluate_stage"]

    def default_config(self) -> dict:
        return {
            "target_dir": "???",
            "prepare_data": {"vcc2018": "???"},
            "build_upstream": {"name": "fbank"},
            # modelrc: projector_dim 256, clipping, attention_pooling,
            # segment_weight 1, bias_weight 1 (mos_prediction/config.yaml)
            "build_downstream": {"projector_dim": 256, "clipping": True,
                                 "attention_pooling": True, "num_judges": 5000},
            "build_task": {"segment_weight": 1.0, "bias_weight": 1.0},
            "build_batch_sampler": {"batch_size": 8},
            "build_optimizer": {"name": "Adam", "lr": 1.0e-4},
            "train": {
                "total_steps": 20000, "log_step": 500, "eval_step": 2000,
                "save_step": 1000, "gradient_accumulate": 2,
            },
        }

    def prepare_data(self, workspace: Path, config: dict):
        """VCC2018 layout: <root>/vcc2018_training_data.csv (+ evaluation csv)
        with WAV_PATH / MEAN / MOS / JUDGE columns and wavs under
        Converted_speech_of_submitted_systems (dataset.py:18-43)."""
        root = Path(config["prepare_data"]["vcc2018"])
        wav_root = root / "Converted_speech_of_submitted_systems"
        judges: dict = {}
        for split, csv_name in [("train", "vcc2018_training_data.csv"),
                                ("valid", "vcc2018_valid_data.csv"),
                                ("test", "vcc2018_testing_data.csv")]:
            src = root / csv_name
            if not src.exists():
                continue
            df = pd.read_csv(src)
            means = df.groupby("WAV_PATH")["MOS"].mean()
            rows = []
            for i, r in df.iterrows():
                wav_name = str(r["WAV_PATH"])
                judge = r.get("JUDGE", 0)
                jid = judges.setdefault(judge, len(judges))
                rows.append(dict(
                    id=f"{split}_{i}",
                    wav_path=str(wav_root / wav_name),
                    mean=float(means[wav_name]),
                    mos=float(r["MOS"]),
                    judge_id=jid,
                    # reference system id: wav_name[:3] + wav_name[-8:-4]
                    system_name=wav_name[:3] + wav_name[-8:-4],
                ))
            if split == "test":  # one row per wav at evaluation
                dedup = {}
                for row in rows:
                    dedup[row["wav_path"]] = row
                rows = list(dedup.values())
            pd.DataFrame(rows).to_csv(workspace / f"{split}.csv", index=False)

    def build_task(self, upstream: SUpstream, config: dict):
        module = MosDownstreamModule(upstream.num_layers, upstream.hidden_sizes[-1],
                                     **config.get("build_downstream", {}))
        return MosPredictionTask(module, **config.get("build_task", {}))

    def build_dataset(self, csv_path, encoder=None):
        return MosRatingDataset(csv_path)

    def _loader(self, workspace, csv_name, encoder, mode, config):
        csv_path = workspace / csv_name
        if not csv_path.exists():
            return None
        ds = self.build_dataset(csv_path)
        sampler = FixedBatchSizeBatchSampler(
            len(ds), config.get("build_batch_sampler", {}).get("batch_size", 8),
            shuffle=(mode == "train"))
        buckets = Buckets.linear(16000, 16000 * 30)
        return DataLoader(ds, sampler, lambda items: pad_collate(items, buckets))

    def _trainer(self, workspace: Path, config: dict):
        """(trainer, no encoder): CommonProblem's train and evaluate stages
        run on it, with this recipe's loader."""
        upstream = self.build_upstream(**config.get("build_upstream", {}))
        task = self.build_task(upstream, config)
        trainer = Trainer(
            upstream.upstream, task, workspace / "train",
            TrainerConfig(optimizer=config.get("build_optimizer", {"name": "Adam", "lr": 1e-4}),
                          **config.get("train", {})),
        )
        return trainer, None


class MosExample(MosPrediction):
    """Smoke test: clean vs noisy tones get high vs low synthetic MOS."""

    def default_config(self) -> dict:
        cfg = super().default_config()
        cfg["prepare_data"] = {"num": 8}
        cfg["build_downstream"]["num_judges"] = 8
        cfg["build_batch_sampler"] = {"batch_size": 2}
        cfg["train"] = {"total_steps": 4, "log_step": 2, "eval_step": 2, "save_step": 2}
        return cfg

    def prepare_data(self, workspace: Path, config: dict):
        from ..util.pseudo_data import _write_wav

        rng = np.random.RandomState(0)
        (workspace / "wavs").mkdir(parents=True, exist_ok=True)
        for split, n in [("train", config["prepare_data"].get("num", 8)),
                         ("valid", 4), ("test", 4)]:
            rows = []
            for i in range(n):
                T = int(16000 * rng.uniform(0.6, 1.6))
                noise_level = float(rng.uniform(0.0, 0.5))
                wav = (np.sin(2 * np.pi * 440 * np.arange(T) / 16000) * 0.3
                       + rng.randn(T) * noise_level).astype(np.float32)
                mean = 5.0 - 4.0 * noise_level / 0.5
                p = workspace / "wavs" / f"{split}_{i}.wav"
                _write_wav(p, wav)
                rows.append(dict(id=f"{split}_{i}", wav_path=str(p),
                                 mean=round(mean, 2),
                                 mos=round(mean + rng.uniform(-0.5, 0.5), 2),
                                 judge_id=int(rng.randint(8)),
                                 system_name=f"sys{i % 2}"))
            pd.DataFrame(rows).to_csv(workspace / f"{split}.csv", index=False)
