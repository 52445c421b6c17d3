"""TERA-era linear/frame probes (port of s3prl_tpu/problem/frame_probe.py;
the legacy downstream experts phone_linear, phone_1hidden,
phone_linear_concat, timit_phone*, speaker_linear_*_libri and
voxceleb1_framelevel).

Behavioral spec per expert config.yaml + expert.py:
- phone probes: frame-aligned 41-class phone labels
  (phone_path/converted_aligned_phones.txt 'utt_id p1 p2 ...',
  train_split.txt with a 90/10 train/dev split seeded by train_dev_seed,
  test_split.txt; phone_linear/dataset.py:33-58); AdamW 2e-4; heads =
  linear / 1x768 hidden / 9-frame concat linear / ConvBank(3,5,7).
- speaker_linear_utter_libri: utterance speaker id, mean-pool linear,
  300k steps; speaker_linear_frame_libri: the same labels broadcast per
  frame, 500k steps.
- voxceleb1_framelevel: the SID speaker set scored per frame
  (modelrc select FrameLevel, projector 256), 200k steps, accum 4.

Frame labels are padded with -100 into 1-s buckets of at most 30 s, as in
the JAX package. The recipes' default upstream is ``fbank``; a run
may name a trunk entry in ``build_upstream``.
"""

from __future__ import annotations

import logging
from pathlib import Path

import numpy as np
import pandas as pd

from .common import CommonProblem, SuperbSID
from ..data.collate import PAD_VALUES, Buckets, pad_collate
from ..data.dataset import _CsvDataset
from ..data.encoder import CategoryEncoder
from ..data.loader import DataLoader
from ..data.sampler import FixedBatchSizeBatchSampler
from ..nn.heads import ConvBankHead, FrameConcatLinear, FrameLevel, FrameLevelLinear, MeanPoolingLinear
from ..nn.upstream import SUpstream, UpstreamDownstreamModel
from ..task.utterance_classification import FrameClassificationTask
from ..train.trainer import Trainer, TrainerConfig

logger = logging.getLogger(__name__)


class FrameLabelDataset(_CsvDataset):
    """Rows carry space-separated frame labels in a 'frame_labels' column."""

    def __getitem__(self, i: int) -> dict:
        row = self.df.iloc[i]
        labels = np.asarray([int(t) for t in str(row["frame_labels"]).split()],
                            np.int32)
        return {
            "x": self._load_wav(row),
            "frame_labels": labels,
            "unique_name": str(row["id"]),
        }


class LibriPhoneLinear(CommonProblem):
    """Legacy downstream/phone_linear: frame phone probe, linear head."""

    NUM_PHONES = 41  # pre-computed in the reference (dataset.py:39)

    def default_config(self) -> dict:
        return {
            "target_dir": "???",
            "prepare_data": {"libri_root": "???", "phone_path": "???",
                             "train_dev_seed": 1337},
            "build_upstream": {"name": "fbank"},
            "build_downstream": {},
            "build_batch_sampler": {"batch_size": 32},
            "build_optimizer": {"name": "AdamW", "lr": 2.0e-4},
            "train": {
                "total_steps": 500000, "log_step": 500, "eval_step": 5000,
                "save_step": 10000,
            },
        }

    def prepare_data(self, workspace: Path, config: dict):
        cfg = config["prepare_data"]
        phone_path = Path(cfg["phone_path"])
        libri_root = Path(cfg["libri_root"])
        labels = {}
        for line in (phone_path / "converted_aligned_phones.txt").read_text().splitlines():
            parts = line.strip().split(" ")
            labels[parts[0]] = " ".join(parts[1:])

        def _rows(ids, split):
            rows = []
            for utt in ids:
                utt = utt.strip()
                if not utt or utt not in labels:
                    continue
                spk, chap, _ = utt.split("-")
                sub = "train-clean-100" if split != "test" else "test-clean"
                rows.append(dict(
                    id=utt,
                    wav_path=str(libri_root / sub / spk / chap / f"{utt}.flac"),
                    frame_labels=labels[utt],
                ))
            return rows

        train_ids = (phone_path / "train_split.txt").read_text().splitlines()
        rng = np.random.RandomState(cfg.get("train_dev_seed", 1337))
        rng.shuffle(train_ids)
        percent = int(len(train_ids) * 0.9)
        pd.DataFrame(_rows(train_ids[:percent], "train")).to_csv(
            workspace / "train.csv", index=False)
        pd.DataFrame(_rows(train_ids[percent:], "valid")).to_csv(
            workspace / "valid.csv", index=False)
        test_ids = (phone_path / "test_split.txt").read_text().splitlines()
        pd.DataFrame(_rows(test_ids, "test")).to_csv(
            workspace / "test.csv", index=False)

    def build_encoder(self, workspace: Path, config: dict):
        return None  # labels are already integer phone ids

    def build_downstream(self, input_size: int, output_size: int, **kwargs):
        return FrameLevelLinear(input_size, output_size)

    def build_task(self, upstream: SUpstream, encoder, config: dict):
        return FrameClassificationTask(self._module(upstream, self.NUM_PHONES, config),
                                       num_classes=self.NUM_PHONES)

    def build_dataset(self, csv_path, encoder=None):
        return FrameLabelDataset(csv_path)

    def _loader(self, workspace, csv_name, encoder, mode, config):
        csv_path = workspace / csv_name
        if not csv_path.exists():
            return None
        ds = self.build_dataset(csv_path, encoder)
        sampler = FixedBatchSizeBatchSampler(
            len(ds), config.get("build_batch_sampler", {}).get("batch_size", 32),
            shuffle=(mode == "train"))
        buckets = Buckets.linear(16000, 16000 * 30)
        return DataLoader(ds, sampler, lambda items: pad_collate(
            items, buckets, pad_keys=PAD_VALUES), distribute=mode == "train")

    def _trainer(self, workspace: Path, config: dict):
        """(trainer, no encoder): CommonProblem's train and evaluate stages
        run on it, with this recipe's loader."""
        upstream = self.build_upstream(**config.get("build_upstream", {}))
        task = self.build_task(upstream, None, config)
        trainer = Trainer(
            upstream.upstream, task, workspace / "train",
            TrainerConfig(optimizer=config.get("build_optimizer", {"name": "AdamW", "lr": 2e-4}),
                          **config.get("train", {})),
        )
        return trainer, None


class LibriPhone1Hidden(LibriPhoneLinear):
    """Legacy downstream/phone_1hidden: one 768 hidden layer, 1M steps."""

    def default_config(self) -> dict:
        cfg = super().default_config()
        cfg["build_downstream"] = {"hidden_size": 768}
        cfg["train"]["total_steps"] = 1000000
        return cfg

    def build_downstream(self, input_size: int, output_size: int, hidden_size: int = 768):
        return FrameLevel(input_size, output_size, hidden_sizes=(hidden_size,))


class LibriPhoneConcat(LibriPhoneLinear):
    """Legacy downstream/phone_linear_concat: 9-frame concat linear, 1M steps."""

    def default_config(self) -> dict:
        cfg = super().default_config()
        cfg["build_downstream"] = {"concat_n_frames": 9}
        cfg["train"]["total_steps"] = 1000000
        return cfg

    def build_downstream(self, input_size: int, output_size: int, concat_n_frames: int = 9):
        return FrameConcatLinear(input_size, output_size, concat_n_frames=concat_n_frames)


class TimitPhoneConvBank(LibriPhoneLinear):
    """Legacy downstream/timit_phone: ConvBank(3,5,7) head, batch 16."""

    def default_config(self) -> dict:
        cfg = super().default_config()
        cfg["prepare_data"] = {"data_root": "???", "phone_path": "???",
                               "train_dev_seed": 1337}
        cfg["build_downstream"] = {"kernels": (3, 5, 7), "cnn_size": 32,
                                   "hidden_size": 64, "dropout": 0.5}
        cfg["build_batch_sampler"] = {"batch_size": 16}
        return cfg

    def build_downstream(self, input_size: int, output_size: int, **kwargs):
        return ConvBankHead(input_size, output_size, **kwargs)

    def prepare_data(self, workspace: Path, config: dict):
        """TIMIT layout: the same converted_aligned_phones.txt format with
        wavs resolved under data_root by utterance id."""
        cfg = config["prepare_data"]
        phone_path = Path(cfg["phone_path"])
        data_root = Path(cfg["data_root"])
        labels = {}
        for line in (phone_path / "converted_aligned_phones.txt").read_text().splitlines():
            parts = line.strip().split(" ")
            labels[parts[0]] = " ".join(parts[1:])

        def _rows(ids):
            return [dict(id=u.strip(),
                         wav_path=str(data_root / f"{u.strip()}.wav"),
                         frame_labels=labels[u.strip()])
                    for u in ids if u.strip() in labels]

        train_ids = (phone_path / "train_split.txt").read_text().splitlines()
        rng = np.random.RandomState(cfg.get("train_dev_seed", 1337))
        rng.shuffle(train_ids)
        percent = int(len(train_ids) * 0.9)
        pd.DataFrame(_rows(train_ids[:percent])).to_csv(workspace / "train.csv", index=False)
        pd.DataFrame(_rows(train_ids[percent:])).to_csv(workspace / "valid.csv", index=False)
        test_ids = (phone_path / "test_split.txt").read_text().splitlines()
        pd.DataFrame(_rows(test_ids)).to_csv(workspace / "test.csv", index=False)


class TimitPhoneLinear(TimitPhoneConvBank):
    """Legacy downstream/timit_phone_linear: linear head, 300k steps."""

    def default_config(self) -> dict:
        cfg = super().default_config()
        cfg["build_downstream"] = {}
        cfg["train"]["total_steps"] = 300000
        return cfg

    def build_downstream(self, input_size: int, output_size: int, **kwargs):
        return FrameLevelLinear(input_size, output_size)


class TimitPhone1Hidden(TimitPhoneConvBank):
    """Legacy downstream/timit_phone_1hidden: 768 hidden, 500k steps."""

    def default_config(self) -> dict:
        cfg = super().default_config()
        cfg["build_downstream"] = {"hidden_size": 768}
        return cfg

    def build_downstream(self, input_size: int, output_size: int, hidden_size: int = 768):
        return FrameLevel(input_size, output_size, hidden_sizes=(hidden_size,))


class TimitPhoneConcat(TimitPhoneConvBank):
    """Legacy downstream/timit_phone_linear_concat: 9-frame concat linear."""

    def default_config(self) -> dict:
        cfg = super().default_config()
        cfg["build_downstream"] = {"concat_n_frames": 9}
        return cfg

    def build_downstream(self, input_size: int, output_size: int, concat_n_frames: int = 9):
        return FrameConcatLinear(input_size, output_size, concat_n_frames=concat_n_frames)


class SpeakerLinearUtter(SuperbSID):
    """Legacy downstream/speaker_linear_utter_libri: mean-pool linear
    speaker probe, AdamW 2e-4, 300k steps, batch 32."""

    def default_config(self) -> dict:
        cfg = super().default_config()
        cfg["prepare_data"] = {"libri_root": "???", "split_file": "???"}
        cfg["build_downstream"] = {}
        cfg["build_batch_sampler"] = {"batch_size": 32}
        cfg["build_optimizer"] = {"name": "AdamW", "lr": 2.0e-4}
        cfg["train"]["total_steps"] = 300000
        cfg["train"]["gradient_accumulate"] = 1
        return cfg

    def prepare_data(self, workspace: Path, config: dict):
        """LibriSpeech speaker probe splits (speaker_linear_utter_libri/
        dataset.py): train/test utterance lists under split_file; the
        speaker is the first '-' field of the utterance id."""
        cfg = config["prepare_data"]
        libri_root = Path(cfg["libri_root"])
        split_dir = Path(cfg["split_file"])
        for split, name in [("train", "train_split.txt"), ("test", "test_split.txt")]:
            f = split_dir / name
            if not f.exists():
                continue
            rows = []
            for utt in f.read_text().splitlines():
                utt = utt.strip()
                if not utt:
                    continue
                spk, chap, _ = utt.split("-")
                rows.append(dict(
                    id=utt,
                    wav_path=str(libri_root / "train-clean-100" / spk / chap / f"{utt}.flac"),
                    label=f"spk{spk}",
                ))
            pd.DataFrame(rows).to_csv(workspace / f"{split}.csv", index=False)

    def build_downstream(self, input_size: int, output_size: int, **kwargs):
        return MeanPoolingLinear(input_size, output_size, **kwargs)


class SpeakerLinearFrame(SpeakerLinearUtter):
    """Legacy downstream/speaker_linear_frame_libri: the same speaker labels
    scored per frame, 500k steps."""

    def default_config(self) -> dict:
        cfg = super().default_config()
        cfg["train"]["total_steps"] = 500000
        return cfg

    def build_task(self, upstream: SUpstream, encoder: CategoryEncoder, config: dict):
        downstream = FrameLevelLinear(upstream.hidden_sizes[-1], len(encoder))
        module = UpstreamDownstreamModel(downstream, upstream.num_layers,
                                         **config.get("build_featurizer", {}))
        return FrameClassificationTask(module, num_classes=len(encoder))


class Voxceleb1FrameLevel(SuperbSID):
    """Legacy downstream/voxceleb1_framelevel: SID scored per frame
    (modelrc select FrameLevel, projector 256), 200k steps, accum 4."""

    def build_task(self, upstream: SUpstream, encoder: CategoryEncoder, config: dict):
        dcfg = config.get("build_downstream", {})
        downstream = FrameLevel(upstream.hidden_sizes[-1], len(encoder),
                                hidden_sizes=(dcfg.get("hidden_size", 256),))
        module = UpstreamDownstreamModel(downstream, upstream.num_layers,
                                         **config.get("build_featurizer", {}))
        return FrameClassificationTask(module, num_classes=len(encoder))


class FrameProbeExample(LibriPhoneLinear):
    """Smoke test: synthetic frame-aligned two-phone tones."""

    def default_config(self) -> dict:
        cfg = super().default_config()
        cfg["prepare_data"] = {"num": 8}
        cfg["build_batch_sampler"] = {"batch_size": 2}
        cfg["train"] = {"total_steps": 4, "log_step": 2, "eval_step": 2,
                        "save_step": 2}
        return cfg

    def prepare_data(self, workspace: Path, config: dict):
        from ..util.pseudo_data import _write_wav

        rng = np.random.RandomState(0)
        (workspace / "wavs").mkdir(parents=True, exist_ok=True)
        for split, n in [("train", config["prepare_data"].get("num", 8)),
                         ("valid", 2), ("test", 2)]:
            rows = []
            for i in range(n):
                secs = rng.uniform(0.5, 1.0)
                T = int(16000 * secs)
                half = T // 2
                wav = np.concatenate([
                    np.sin(2 * np.pi * 300 * np.arange(half) / 16000),
                    np.sin(2 * np.pi * 600 * np.arange(T - half) / 16000),
                ]).astype(np.float32) * 0.3
                # 100 fps frame labels (the reference alignment frame rate)
                n_frames = T // 160
                labs = [0 if f * 160 < half else 1 for f in range(n_frames)]
                p = workspace / "wavs" / f"{split}_{i}.wav"
                _write_wav(p, wav)
                rows.append(dict(id=f"{split}_{i}", wav_path=str(p),
                                 frame_labels=" ".join(map(str, labs))))
            pd.DataFrame(rows).to_csv(workspace / f"{split}.csv", index=False)
