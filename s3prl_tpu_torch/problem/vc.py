"""Voice conversion problem (port of s3prl_tpu/problem/vc.py; the
reference's downstream/a2o-vc-vcc2020).

Stage 0: VCC2020-style data, source-speaker utterances paired with the
target speaker's utterance of the same text; the CSVs carry the source wav
and the target wav, whose log-mel (`ops.audio.log_mel`, 80 bins at a
160-sample hop) is the training target. Stage 1 trains the Taco2-AR
decoder over the upstream's features (`models.taco2ar`) with the weighted
sum of its layers, the features cut to the target's frames. Stage 2
scores DTW-MCD and writes Griffin-Lim waves under ``wav_hyp/``
(`ops.vocoder`; the reference downloads a neural vocoder instead).

The decoder joins the features to the mels frame by frame, which lines up
at the mels' 160-sample hop only: over an upstream of stride 320 the
features have half the frames and the step raises TypeError, as the JAX
package's concatenate does (ROADMAP.md Queue 3, "Not port faults").
"""

from __future__ import annotations

import logging
from pathlib import Path

import numpy as np
import pandas as pd
import torch
import torch.nn as nn
import yaml

from .base import Problem
from ..data.collate import Buckets, pad_collate
from ..data.dataset import _CsvDataset
from ..data.loader import DataLoader
from ..data.sampler import FixedBatchSizeBatchSampler
from ..models.taco2ar import Taco2ARConfig, Taco2ARDecoder
from ..nn.upstream import Featurizer, SUpstream
from ..ops import audio as audio_ops
from ..task.voice_conversion import VoiceConversionTask
from ..train import checkpoint as ckpt
from ..train.trainer import Trainer, TrainerConfig

logger = logging.getLogger(__name__)


class _VcDataset(_CsvDataset):
    """Rows: wav_path (the source audio), target_path (the target speaker's)."""

    def __getitem__(self, i):
        from ..data.audio import load_wav

        row = self.df.iloc[i]
        wav = self._load_wav(row)
        target_wav, _ = load_wav(row.get("target_path", row["wav_path"]), self.sample_rate)
        mel, _ = audio_ops.log_mel(torch.from_numpy(np.asarray(target_wav, np.float32)[None]),
                                   n_mels=80)
        return {"x": wav, "target_mel": mel[0].numpy(), "unique_name": str(row["id"])}


class VcModel(nn.Module):
    """The featurizer over the upstream's layers, then the decoder on the
    first T features (T the previous mels' frames): (hs, h_lens,
    prev_mels, generator) -> (pred_mel, h_lens)."""

    def __init__(self, num_layers: int, input_size: int, cfg: Taco2ARConfig):
        super().__init__()
        self.featurizer = Featurizer(num_layers)
        self.decoder = Taco2ARDecoder(cfg, input_size)

    def forward(self, hs, h_lens, prev_mels, generator=None):
        h, lens = self.featurizer(hs, h_lens)
        T = prev_mels.shape[1]
        if h.shape[1] < T:
            raise TypeError(
                f"the upstream's features have {h.shape[1]} frames and the target mels {T}: "
                "the decoder joins them frame by frame, which needs the mels' 160-sample hop "
                "(the JAX package's concatenate raises TypeError here)")
        return self.decoder(h[:, :T], prev_mels, generator=generator), lens


class VcVcc2020(Problem):
    STAGES = ["prepare_data", "train_stage", "evaluate_stage"]

    def default_config(self) -> dict:
        return {
            "target_dir": "???",
            "prepare_data": {"vcc2020": "???", "target_speaker": "TEF1"},
            "build_upstream": {"name": "fbank"},
            "build_downstream": {"lstm_units": 512, "num_lstm_layers": 2},
            "build_batch_sampler": {"batch_size": 6},
            # AdamW 1e-4, 10k steps, batch 6 (legacy a2o-vc-vcc2020/
            # config.yaml; the a2a-vc-vctk variant trains 50k)
            "build_optimizer": {"name": "AdamW", "lr": 1.0e-4},
            "train": {"total_steps": 10000, "log_step": 500, "eval_step": 2000, "save_step": 1000},
        }

    def prepare_data(self, workspace: Path, config: dict):
        """VCC2020 layout: <root>/<speaker>/<utt>.wav; parallel utt ids."""
        cfg = config["prepare_data"]
        root = Path(cfg["vcc2020"])
        target_spk = cfg.get("target_speaker", "TEF1")
        src_spks = cfg.get("source_speakers", ["SEF1", "SEF2", "SEM1", "SEM2"])
        rows = []
        for spk in src_spks:
            for wav in sorted((root / spk).glob("*.wav")):
                tgt = root / target_spk / wav.name
                if tgt.exists():
                    rows.append(dict(id=f"{spk}-{wav.stem}", wav_path=str(wav),
                                     target_path=str(tgt)))
        df = pd.DataFrame(rows)
        n_valid = max(len(df) // 10, 1)
        df.iloc[n_valid:].to_csv(workspace / "train.csv", index=False)
        df.iloc[:n_valid].to_csv(workspace / "valid.csv", index=False)
        df.iloc[:n_valid].to_csv(workspace / "test.csv", index=False)

    def build_upstream(self, name: str = "fbank", **kwargs) -> SUpstream:
        return SUpstream(name, **kwargs)

    def build_task(self, upstream: SUpstream, config: dict):
        d_cfg = config.get("build_downstream", {})
        module = VcModel(upstream.num_layers, upstream.hidden_sizes[-1],
                         Taco2ARConfig(mel_dim=80, **d_cfg))
        return VoiceConversionTask(module, mel_dim=80)

    def _loader(self, workspace, csv_name, mode, config):
        csv_path = workspace / csv_name
        if not csv_path.exists():
            return None
        ds = _VcDataset(csv_path)
        cfg = config.get("build_batch_sampler", {})
        sampler = FixedBatchSizeBatchSampler(len(ds), cfg.get("batch_size", 6),
                                             shuffle=(mode == "train"))
        buckets = Buckets.linear(config.get("bucket_step", 16000), 16000 * 30)
        return DataLoader(ds, sampler, lambda items: pad_collate(items, buckets),
                          distribute=mode == "train")

    def _trainer(self, workspace, config):
        upstream = self.build_upstream(**config.get("build_upstream", {"name": "fbank"}))
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
        best = workspace / "train" / "valid_best"
        load_dir = best if best.exists() else ckpt.latest_checkpoint(workspace / "train")
        if load_dir is not None:
            trainer.task.module.load_state_dict(ckpt.load_checkpoint(load_dir, trainer.device)[0])
        if config.get("synthesize", True):
            trainer.task.wav_dir = workspace / "wav_hyp"
        logs = trainer.evaluate(loader, mode="test")
        with open(workspace / "result.yaml", "w") as f:
            yaml.safe_dump({"test": logs}, f)
        return {"test": logs}


class VcExample(VcVcc2020):
    """Smoke test: identity 'conversion' on pseudo audio."""

    def default_config(self) -> dict:
        cfg = super().default_config()
        cfg["prepare_data"] = {"num": 6}
        cfg["build_downstream"] = {"lstm_units": 24, "num_lstm_layers": 1,
                                   "prenet_units": 16, "postnet_channels": 16, "postnet_layers": 2}
        cfg["build_batch_sampler"] = {"batch_size": 2}
        cfg["train"] = {"total_steps": 2, "log_step": 1, "eval_step": 2, "save_step": 2}
        return cfg

    def prepare_data(self, workspace: Path, config: dict):
        from ..util.pseudo_data import _write_wav

        rng = np.random.RandomState(0)
        (workspace / "wavs").mkdir(parents=True, exist_ok=True)
        for split, n in [("train", config["prepare_data"].get("num", 6)), ("valid", 2),
                         ("test", 2)]:
            rows = []
            for i in range(n):
                wav = (rng.randn(int(16000 * rng.uniform(0.4, 0.8))) * 0.1).astype(np.float32)
                p = workspace / "wavs" / f"{split}_{i}.wav"
                _write_wav(p, wav)
                rows.append(dict(id=f"{split}_{i}", wav_path=str(p), target_path=str(p)))
            pd.DataFrame(rows).to_csv(workspace / f"{split}.csv", index=False)
