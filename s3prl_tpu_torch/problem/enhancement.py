"""Speech enhancement and separation problems, SUPERB-SG SE / SS (port of
s3prl_tpu/problem/enhancement.py).

Behavioral spec from the reference (s3prl/downstream/enhancement_stft,
separation_stft2; Libri2Mix-style data: mixture waves paired with source
waves, BLSTM STFT-mask heads, PIT for separation, SI-SDRi evaluation):
stage 0 writes CSVs with ``wav_path`` (the mixture) and ``source_1..N``
columns, stage 1 trains on the magnitude MSE, stage 2 reconstructs with the
mixture's phase and reports the SI-SDR improvement over the mixture (SE:
also STOI and PESQ). The recipes' default upstream is ``fbank``.
"""

from __future__ import annotations

import logging
from pathlib import Path

import numpy as np
import pandas as pd
import yaml

from .base import Problem
from ..data.collate import Buckets, pad_collate
from ..data.dataset import _CsvDataset
from ..data.loader import DataLoader
from ..data.sampler import FixedBatchSizeBatchSampler
from ..nn.upstream import SUpstream, UpstreamDownstreamModel
from ..task.enhancement import EnhancementTask, SeparationTask
from ..train import checkpoint as ckpt
from ..train.trainer import Trainer, TrainerConfig

logger = logging.getLogger(__name__)


class _MixtureDataset(_CsvDataset):
    def __init__(self, csv_path, num_sources: int, sample_rate=16000):
        super().__init__(csv_path, sample_rate)
        self.num_sources = num_sources

    def __getitem__(self, i):
        from ..data.audio import load_wav

        row = self.df.iloc[i]
        mix = self._load_wav(row)
        sources = [
            load_wav(row[f"source_{s + 1}"], self.sample_rate)[0][: len(mix)]
            for s in range(self.num_sources)
        ]
        srcs = np.zeros((self.num_sources, len(mix)), np.float32)
        for s, w in enumerate(sources):
            srcs[s, : len(w)] = w
        # sources as [T, S], so the collate pads the time axis
        return {"x": mix, "sources": srcs.T, "unique_name": str(row["id"])}


class SuperbSS(Problem):
    """Source separation (reference: downstream/separation_stft2)."""

    num_sources = 2
    STAGES = ["prepare_data", "train_stage", "evaluate_stage"]

    def default_config(self) -> dict:
        return {
            "target_dir": "???",
            "prepare_data": {"libri2mix": "???"},
            "build_upstream": {"name": "fbank"},
            # SepRNN (separation_stft2/configs/cfg.yaml modelrc: 3-layer
            # bidirectional LSTM, hidden 256, dropout 0.1; AdamW 1e-3, 150k
            # steps, train_batchsize 8)
            "build_downstream": {"hidden_size": 256, "num_layers": 3,
                                 "dropout": 0.1},
            "build_batch_sampler": {"batch_size": 8},
            "build_optimizer": {"name": "AdamW", "lr": 1.0e-3},
            "train": {
                "total_steps": 150000, "log_step": 500,
                "eval_step": 5000, "save_step": 1000,
            },
        }

    def prepare_data(self, workspace: Path, config: dict):
        """Libri2Mix's layout: metadata/mixture_{split}_mix_clean.csv."""
        root = Path(config["prepare_data"]["libri2mix"])
        for split, name in [("train", "train-100"), ("valid", "dev"), ("test", "test")]:
            meta = root / "wav16k" / "min" / "metadata" / f"mixture_{name}_mix_clean.csv"
            if not meta.exists():
                continue
            df = pd.read_csv(meta)
            out = pd.DataFrame(
                dict(
                    id=df["mixture_ID"],
                    wav_path=df["mixture_path"],
                    source_1=df["source_1_path"],
                    source_2=df["source_2_path"],
                )
            )
            out.to_csv(workspace / f"{split}.csv", index=False)

    def build_upstream(self, name: str = "fbank", **kwargs) -> SUpstream:
        return SUpstream(name, **kwargs)

    def build_task(self, upstream: SUpstream, config: dict):
        from ..nn.heads import RNNEncoder

        # the SepRNN mask estimator (separation_stft2 model.py: stacked
        # bidirectional LSTMs -> a linear mask head; the task applies the
        # sigmoid) as RNNEncoder, the same stack with a projection a layer;
        # the STFT is enhancement_stft2's 512 / 400 / 160
        dcfg = config.get("build_downstream", {})
        head = RNNEncoder(
            upstream.hidden_sizes[-1],
            output_size=self.num_sources * 257,
            hidden_size=dcfg.get("hidden_size", 256),
            num_layers=dcfg.get("num_layers", 3),
            bidirectional=dcfg.get("bidirectional", True),
            dropout=dcfg.get("dropout", 0.1),
            proj_size=dcfg.get("hidden_size", 256),
            carry_padding=True,  # the reconstruction reads the padded frames' masks
        )
        module = UpstreamDownstreamModel(
            downstream=head, num_layers=upstream.num_layers,
            **config.get("build_featurizer", {}),
        )
        if self.num_sources == 1:
            # SE scores si_sdr / stoi / pesq and keeps the dev-best by PESQ
            # (enhancement_stft/expert.py:38,383-385)
            return EnhancementTask(module)
        return SeparationTask(module, num_sources=self.num_sources)

    def _loader(self, workspace, csv_name, mode, config):
        csv_path = workspace / csv_name
        if not csv_path.exists():
            return None
        ds = _MixtureDataset(csv_path, self.num_sources)
        cfg = config.get("build_batch_sampler", {})
        sampler = FixedBatchSizeBatchSampler(len(ds), cfg.get("batch_size", 6),
                                             shuffle=(mode == "train"))
        buckets = Buckets.linear(config.get("bucket_step", 16000), 16000 * 30)

        def collate(items):
            batch = pad_collate(items, buckets)
            batch["sources"] = np.transpose(batch["sources"], (0, 2, 1))  # [B, S, T]
            return batch

        return DataLoader(ds, sampler, collate, distribute=mode == "train")

    def _trainer(self, workspace, config):
        upstream = self.build_upstream(**config.get("build_upstream", {}))
        task = self.build_task(upstream, config)
        return Trainer(
            upstream.upstream, task, workspace / "train",
            TrainerConfig(optimizer=config.get("build_optimizer", {"name": "Adam", "lr": 1e-4}),
                          **config.get("train", {})),
        )

    def train_stage(self, workspace: Path, config: dict):
        trainer = self._trainer(workspace, config)
        trainer.train(
            self._loader(workspace, "train.csv", "train", config),
            self._loader(workspace, "valid.csv", "valid", config),
        )
        return trainer

    def evaluate_stage(self, workspace: Path, config: dict):
        trainer = self._trainer(workspace, config)
        loader = self._loader(workspace, "test.csv", "test", config)
        trainer.init(resume=False)
        # the dev-best checkpoint (SE: best mean PESQ; SS: best si_sdr), else
        # the newest step
        best = workspace / "train" / "valid_best"
        load_dir = best if best.exists() else ckpt.latest_checkpoint(workspace / "train")
        if load_dir is not None:
            trainer.task.module.load_state_dict(ckpt.load_checkpoint(load_dir, trainer.device)[0])
        # the eval step caches the reconstructions; the reduction scores
        # si_sdr (SE: + stoi / pesq) per utterance in the PIT order
        logs = trainer.evaluate(loader, "test")
        with open(workspace / "result.yaml", "w") as f:
            yaml.safe_dump({"test": logs}, f)
        return {"test": logs}


class SuperbSE(SuperbSS):
    """Enhancement (reference: downstream/enhancement_stft): one source."""

    num_sources = 1

    def default_config(self) -> dict:
        cfg = super().default_config()
        cfg["prepare_data"] = {"voicebank": "???"}
        # enhancement_stft2/configs/cfg_voicebank.yaml: 100k steps
        cfg["train"]["total_steps"] = 100000
        return cfg

    def prepare_data(self, workspace: Path, config: dict):
        """Voicebank-DEMAND's layout: noisy/ and clean/ wav dirs a split."""
        root = Path(config["prepare_data"]["voicebank"])
        for split, noisy, clean in [
            ("train", "noisy_trainset_wav", "clean_trainset_wav"),
            ("test", "noisy_testset_wav", "clean_testset_wav"),
        ]:
            noisy_dir = root / noisy
            if not noisy_dir.is_dir():
                continue
            rows = [
                dict(id=p.stem, wav_path=str(p), source_1=str(root / clean / p.name))
                for p in sorted(noisy_dir.glob("*.wav"))
            ]
            pd.DataFrame(rows).to_csv(workspace / f"{split}.csv", index=False)


class SeExample(SuperbSE):
    """Smoke test: noise + tone mixtures."""

    def default_config(self) -> dict:
        cfg = super().default_config()
        cfg["prepare_data"] = {"num": 6}
        cfg["build_batch_sampler"] = {"batch_size": 2}
        cfg["train"] = {"total_steps": 4, "log_step": 2, "eval_step": 2, "save_step": 2}
        return cfg

    def prepare_data(self, workspace: Path, config: dict):
        from ..util.pseudo_data import _write_wav

        rng = np.random.RandomState(0)
        (workspace / "wavs").mkdir(parents=True, exist_ok=True)
        for split, n in [("train", config["prepare_data"].get("num", 6)), ("valid", 2), ("test", 2)]:
            rows = []
            for i in range(n):
                T = int(16000 * rng.uniform(0.5, 1.0))
                clean = np.sin(2 * np.pi * 440 * np.arange(T) / 16000).astype(np.float32) * 0.3
                noise = rng.randn(T).astype(np.float32) * 0.1
                mix_p = workspace / "wavs" / f"{split}_{i}_mix.wav"
                clean_p = workspace / "wavs" / f"{split}_{i}_clean.wav"
                _write_wav(mix_p, clean + noise)
                _write_wav(clean_p, clean)
                rows.append(dict(id=f"{split}_{i}", wav_path=str(mix_p), source_1=str(clean_p)))
            pd.DataFrame(rows).to_csv(workspace / f"{split}.csv", index=False)
