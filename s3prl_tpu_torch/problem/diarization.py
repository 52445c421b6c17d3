"""Speaker diarization problem, SUPERB SD (port of s3prl_tpu/problem/
diarization.py).

Behavioral spec from the reference (s3prl/problem/diarization/run.py:26 +
superb_sd.py:67-90): stage 0 chunk kaldi-style data dirs into frame-label
windows (20 s: 2,000 frames of 160 samples), stage 1 (no encoder needed),
stage 2 train the frame-level LSTM head with permutation-invariant BCE
(Adam 1e-4, 30k steps, accum 4), stage 3 accumulate DER over test chunks
(valid_best, else the newest step) and write the hypothesis RTTM. The
recipes' default upstream is ``fbank``; a run may name a trunk entry in
``build_upstream``.
"""

from __future__ import annotations

import logging
from pathlib import Path

import numpy as np
import yaml

from .base import Problem
from ..data.collate import Buckets, pad_collate
from ..data.dataset import DiarizationChunkDataset
from ..data.loader import DataLoader
from ..data.sampler import FixedBatchSizeBatchSampler
from ..nn.speaker import SuperbDiarizationModel
from ..nn.upstream import SUpstream, UpstreamDownstreamModel
from ..task.diarization import DiarizationPITTask
from ..train import checkpoint as ckpt
from ..train.trainer import Trainer, TrainerConfig

logger = logging.getLogger(__name__)


class SuperbSD(Problem):
    STAGES = ["prepare_data", "train_stage", "evaluate_stage"]

    def default_config(self) -> dict:
        return {
            "target_dir": "???",
            "prepare_data": {"train_dir": "???", "valid_dir": "???", "test_dir": "???"},
            "build_upstream": {"name": "fbank"},
            # hidden 512 / 1 LSTM layer (superb_sd.py:61-62; legacy
            # diarization/config.yaml modelrc rnn_layers 1)
            "build_downstream": {"hidden_size": 512, "num_layers": 1},
            "build_batch_sampler": {"batch_size": 8},
            "build_optimizer": {"name": "Adam", "lr": 1.0e-4},
            "num_speakers": 2,
            "train": {
                "total_steps": 30000,
                "log_step": 500,
                "eval_step": 5000,
                "save_step": 1000,
                "gradient_clipping": 1.0,
                "gradient_accumulate": 4,
            },
        }

    def prepare_data(self, workspace: Path, config: dict):
        from ..data.corpus.kaldi_diar import prepare_diarization

        return prepare_diarization(
            workspace, num_speakers=config.get("num_speakers", 2),
            **config.get("prepare_data", {}),
        )

    def build_upstream(self, name: str = "fbank", **kwargs) -> SUpstream:
        return SUpstream(name, **kwargs)

    def build_task(self, upstream: SUpstream, config: dict):
        num_spk = config.get("num_speakers", 2)
        downstream = SuperbDiarizationModel(
            upstream.hidden_sizes[-1], output_size=num_spk, **config.get("build_downstream", {})
        )
        module = UpstreamDownstreamModel(downstream, upstream.num_layers,
                                         **config.get("build_featurizer", {}))
        return DiarizationPITTask(module, num_speakers=num_spk)

    def _loader(self, workspace, csv_name, mode, config):
        csv_path = workspace / csv_name
        if not csv_path.exists():
            return None
        ds = DiarizationChunkDataset(csv_path)
        cfg = config.get("build_batch_sampler", {})
        sampler = FixedBatchSizeBatchSampler(
            len(ds), cfg.get("batch_size", 8), shuffle=(mode == "train")
        )
        buckets = Buckets.linear(config.get("bucket_step", 16000), 16000 * 30)
        return DataLoader(ds, sampler, lambda items: pad_collate(items, buckets))

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
        train_loader = self._loader(workspace, "train.csv", "train", config)
        valid_loader = self._loader(workspace, "valid.csv", "valid", config)
        trainer.train(train_loader, valid_loader)
        return trainer

    def evaluate_stage(self, workspace: Path, config: dict):
        trainer = self._trainer(workspace, config)
        loader = self._loader(workspace, "test.csv", "test", config)
        trainer.init(resume=False)
        best = workspace / "train" / "valid_best"
        load_dir = best if best.exists() else ckpt.latest_checkpoint(workspace / "train")
        if load_dir is not None:
            trainer.task.module.load_state_dict(ckpt.load_checkpoint(load_dir, trainer.device)[0])
        # hypothesis RTTMs land next to the scores (reference diarization
        # inference writes RTTM during test, task/diarization.py)
        trainer.task.rttm_dir = workspace / "rttm"
        logs = trainer.evaluate(loader, mode="test")
        with open(workspace / "result.yaml", "w") as f:
            yaml.safe_dump({"test": logs}, f)
        return {"test": logs}


class SdExample(SuperbSD):
    """Smoke-test SD: synthesized 2-speaker recordings (tones vs noise)."""

    def default_config(self) -> dict:
        cfg = super().default_config()
        cfg["prepare_data"] = {"num_recordings": 3, "secs": 4.0}
        cfg["build_downstream"] = {"hidden_size": 32, "num_layers": 1}
        cfg["build_batch_sampler"] = {"batch_size": 2}
        cfg["train"] = {"total_steps": 4, "log_step": 2, "eval_step": 2, "save_step": 2}
        return cfg

    def prepare_data(self, workspace: Path, config: dict):
        from ..data.corpus.kaldi_diar import prepare_diarization
        from ..util.pseudo_data import _write_wav

        cfg = config.get("prepare_data", {})
        rng = np.random.RandomState(0)
        n = cfg.get("num_recordings", 3)
        secs = cfg.get("secs", 4.0)
        for split in ["train", "valid", "test"]:
            data_dir = workspace / f"kaldi_{split}"
            data_dir.mkdir(parents=True, exist_ok=True)
            wav_scp, segments, utt2spk = [], [], []
            for r in range(n):
                reco = f"{split}_reco{r}"
                wav = (rng.randn(int(16000 * secs)) * 0.05).astype(np.float32)
                path = workspace / "wavs" / f"{reco}.wav"
                path.parent.mkdir(exist_ok=True)
                _write_wav(path, wav)
                wav_scp.append(f"{reco} {path}")
                # two overlapping speakers
                half = secs / 2
                for u, (spk, s, e) in enumerate(
                    [("A", 0.0, half + 0.5), ("B", half - 0.5, secs)]
                ):
                    utt = f"{reco}_u{u}"
                    segments.append(f"{utt} {reco} {s:.2f} {e:.2f}")
                    utt2spk.append(f"{utt} {spk}")
            (data_dir / "wav.scp").write_text("\n".join(wav_scp))
            (data_dir / "segments").write_text("\n".join(segments))
            (data_dir / "utt2spk").write_text("\n".join(utt2spk))
        prepare_diarization(
            workspace,
            train_dir=workspace / "kaldi_train",
            valid_dir=workspace / "kaldi_valid",
            test_dir=workspace / "kaldi_test",
            chunk_size=200,
            num_speakers=2,
        )
