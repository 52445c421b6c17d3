"""HEAR 2021 benchmark problems (port of s3prl_tpu/problem/hear.py).

Behavioral spec from the reference (s3prl/problem/common/hear_*.py - 16
recipes over two shared task shapes): every HEAR dataset is either a *scene*
task (one (multi)label per clip; e.g. hear_esc50, hear_gsc5hr,
hear_cremad, hear_vocal, hear_libricount, ...) or a *timestamp/event* task
(frame-level multilabel; hear_dcase, hear_maestro). Data comes from the
standardized HEAR task folders; here prepare_data consumes CSVs with
`label` (scene) or `events` (event) columns.

As in the JAX package, the event loader pads to 1-s buckets of at most 30
s, so a longer clip (DCASE 2016 Task 2's 120-s recordings) fails the
collation (the scene recipes take CommonProblem's ``bucket_max``); the
event labels are 10-ms frames, cut by the task to the states' 20-ms frames.
The recipes' default upstream is ``fbank``; a run may name a trunk entry
in ``build_upstream``.
"""

from __future__ import annotations

import json
import logging
from pathlib import Path

import numpy as np
import pandas as pd
import yaml

from .base import Problem
from .common import CommonProblem
from ..data.audio import audio_info, load_wav
from ..data.collate import Buckets, pad_collate
from ..data.encoder import CategoryEncoder
from ..data.loader import DataLoader
from ..data.sampler import FixedBatchSizeBatchSampler
from ..nn.heads import FrameLevel, UtteranceLevel
from ..nn.upstream import SUpstream, UpstreamDownstreamModel
from ..task.hear import EventPredictionTask, ScenePredictionTask
from ..train import checkpoint as ckpt
from ..train.trainer import Trainer, TrainerConfig

logger = logging.getLogger(__name__)


class _MultiLabelSceneDataset:
    """CSV rows with `labels` (";"-joined) -> multi-hot vectors."""

    def __init__(self, csv_path, encoder, sample_rate: int = 16000):
        self.df = pd.read_csv(csv_path)
        self.encoder = encoder
        self.sample_rate = sample_rate

    def __len__(self):
        return len(self.df)

    def __getitem__(self, i):
        row = self.df.iloc[i]
        wav, _ = load_wav(row["wav_path"], self.sample_rate)
        hot = np.zeros((len(self.encoder),), np.float32)
        labels = str(row.get("labels", "") or "")
        for lab in labels.split(";"):
            lab = lab.strip()
            if lab:
                hot[int(self.encoder.encode(lab))] = 1.0
        return {"x": wav, "multilabel": hot, "unique_name": str(row["id"])}


def _split_labels(cell) -> list:
    return [s.strip() for s in str(cell or "").split(";") if s.strip()]


def _audio_sub(task_dir: Path) -> str:
    return "16000" if (task_dir / "16000").exists() else "audio"


class HearScene(CommonProblem):
    """Generic HEAR scene-prediction recipe (clip-level classification).

    Mirrors the reference's two data layouts (problem/common/hear_fsd.py
    hear_scene_trainvaltest and hear_esc50.py hear_scene_kfolds): HEAR task
    folders ship either {train,valid,test}.json or fold{i:02d}.json mapping
    clip -> label(s). Set `num_folds` (+ config prepare_data.test_fold) for
    the k-fold family; valid = (test_fold + 1) % num_folds, train = rest.
    """

    dataset_name = "hear_generic"
    multilabel = False
    scores = ("top1_acc",)
    num_folds = None  # k-fold datasets set this
    chroma = False  # nsynth pitch: report chroma accuracy too
    batch_size = 32
    total_steps = 150000

    def default_config(self) -> dict:
        prep = {"task_dir": "???"}
        if self.num_folds:
            prep["test_fold"] = 0
        return {
            "target_dir": "???",
            "prepare_data": prep,
            "build_upstream": {"name": "fbank"},
            "build_downstream": {"hidden_size": 1024},
            "build_batch_sampler": {"batch_size": self.batch_size},
            "build_optimizer": {"name": "Adam", "lr": 1.0e-3},
            "train": {
                "total_steps": self.total_steps, "log_step": 100,
                "eval_step": 1000, "save_step": 1000,
            },
        }

    def _rows(self, task_dir: Path, meta_name: str, audio_sub: str) -> list:
        entries = json.loads((task_dir / meta_name).read_text())
        rows = []
        for clip, label in entries.items():
            labels = label if isinstance(label, list) else [label]
            labels = [str(lab).strip() for lab in labels]
            rows.append(
                dict(
                    id=clip.replace("/", "-"),
                    wav_path=str(task_dir / audio_sub / clip),
                    label=labels[0] if labels else "",
                    labels=" ; ".join(labels).replace(" ; ", ";"),
                )
            )
        return rows

    def prepare_data(self, workspace: Path, config: dict):
        task_dir = Path(config["prepare_data"]["task_dir"])
        audio_sub = _audio_sub(task_dir)
        if self.num_folds:
            test_fold = int(config["prepare_data"].get("test_fold", 0))
            valid_fold = (test_fold + 1) % self.num_folds
            folds = {
                i: self._rows(task_dir, f"fold{i:02d}.json", f"{audio_sub}/fold{i:02d}"
                              if (task_dir / audio_sub / f"fold{i:02d}").exists()
                              else audio_sub)
                for i in range(self.num_folds)
            }
            train_rows = [
                r for i, rows in folds.items()
                if i not in (test_fold, valid_fold) for r in rows
            ]
            pd.DataFrame(train_rows).to_csv(workspace / "train.csv", index=False)
            pd.DataFrame(folds[valid_fold]).to_csv(workspace / "valid.csv", index=False)
            pd.DataFrame(folds[test_fold]).to_csv(workspace / "test.csv", index=False)
            return
        for split in ["train", "valid", "test"]:
            if not (task_dir / f"{split}.json").exists():
                continue
            sub = f"{audio_sub}/{split}" if (task_dir / audio_sub / split).exists() else audio_sub
            pd.DataFrame(self._rows(task_dir, f"{split}.json", sub)).to_csv(
                workspace / f"{split}.csv", index=False
            )

    def build_encoder(self, workspace: Path, config: dict):
        df = pd.read_csv(workspace / "train.csv")
        col = df["labels"] if "labels" in df.columns else df["label"]
        all_labels = [lab for cell in col for lab in _split_labels(cell)] or ["<none>"]
        encoder = CategoryEncoder(all_labels)
        encoder.save(workspace / "encoder.json")
        return encoder

    def build_dataset(self, csv_path, encoder):
        if self.multilabel:
            return _MultiLabelSceneDataset(csv_path, encoder)
        return super().build_dataset(csv_path, encoder)

    def build_task(self, upstream: SUpstream, encoder, config: dict):
        downstream = UtteranceLevel(
            upstream.hidden_sizes[-1], len(encoder),
            hidden_sizes=(config.get("build_downstream", {}).get("hidden_size", 1024),),
        )
        module = UpstreamDownstreamModel(downstream, upstream.num_layers,
                                         **config.get("build_featurizer", {}))
        class_values = None
        if self.chroma:
            vals = []
            for i in range(len(encoder)):
                lab = encoder.decode(i)
                try:
                    vals.append(int(lab))
                except ValueError:
                    vals.append(i)
            class_values = np.asarray(vals)
        return ScenePredictionTask(
            module, num_classes=len(encoder), multilabel=self.multilabel,
            scores=self.scores, class_values=class_values,
        )


# ---------------------------------------------------------------------------
# the 16 named recipes (reference: s3prl/problem/common/hear_*.py) - scene
# recipes differ in fold layout / prediction type / score set; dcase and
# maestro are timestamp (event) tasks and subclass HearEvent below.
# ---------------------------------------------------------------------------


class HearFSD(HearScene):
    """FSD50k: multilabel tagging (hear_fsd.py)."""

    dataset_name = "hear_fsd"
    multilabel = True
    scores = ("mAP", "top1_acc", "d_prime", "aucroc")
    batch_size = 10
    total_steps = 40000


class HearESC50(HearScene):
    """ESC-50: 5-fold multiclass (hear_esc50.py)."""

    dataset_name = "hear_esc50"
    scores = ("top1_acc", "mAP", "d_prime", "aucroc")
    num_folds = 5


class HearBeijingOpera(HearESC50):
    dataset_name = "hear_beijing_opera"
    num_folds = 5


class HearCremaD(HearESC50):
    dataset_name = "hear_cremad"
    num_folds = 5


class HearGtzan(HearESC50):
    dataset_name = "hear_gtzan"
    num_folds = 10


class HearGtzanMusicSpeech(HearESC50):
    dataset_name = "hear_gtzan_music_speech"
    num_folds = 5


class HearGunshot(HearESC50):
    dataset_name = "hear_gunshot"
    num_folds = 7


class HearLibriCount(HearESC50):
    dataset_name = "hear_libricount"
    num_folds = 5


class HearStroke(HearESC50):
    dataset_name = "hear_stroke"
    num_folds = 5


class HearTonic(HearESC50):
    dataset_name = "hear_tonic"
    num_folds = 5


class HearVocal(HearESC50):
    dataset_name = "hear_vocal"
    scores = ("mAP", "top1_acc", "d_prime", "aucroc")
    num_folds = 3


class HearVoxLingual(HearESC50):
    dataset_name = "hear_vox_lingual"
    num_folds = 5


class HearGSC5hr(HearScene):
    """Speech Commands 5 hr: train/valid/test multiclass (hear_gsc5hr.py)."""

    dataset_name = "hear_gsc5hr"
    scores = ("top1_acc",)


class HearNsynth5hr(HearScene):
    """NSynth pitch 5 hr: pitch + chroma accuracy (hear_nsynth5hr.py)."""

    dataset_name = "hear_nsynth5hr"
    scores = ("pitch_acc", "chroma_acc")
    chroma = True


class _EventDataset:
    """CSV rows: wav_path + events_path (.npy [T, num_classes] frame labels)."""

    def __init__(self, csv_path, sample_rate=16000):
        self.df = pd.read_csv(csv_path)
        self.sample_rate = sample_rate

    def __len__(self):
        return len(self.df)

    def __getitem__(self, i):
        row = self.df.iloc[i]
        wav, _ = load_wav(row["wav_path"], self.sample_rate)
        labels = np.load(row["events_path"]).astype(np.int32)
        return {"x": wav, "frame_labels": labels, "unique_name": str(row["id"])}


class HearEvent(Problem):
    """Timestamp (event) HEAR recipes - hear_dcase / hear_maestro."""

    STAGES = ["prepare_data", "train_stage", "evaluate_stage"]

    def default_config(self) -> dict:
        return {
            "target_dir": "???",
            "prepare_data": {"task_dir": "???"},
            "build_upstream": {"name": "fbank"},
            "build_downstream": {"hidden_size": 256},
            "num_classes": "???",
            "build_batch_sampler": {"batch_size": 8},
            "build_optimizer": {"name": "Adam", "lr": 1.0e-3},
            "train": {"total_steps": 40000, "log_step": 100, "eval_step": 1000, "save_step": 1000},
        }

    def prepare_data(self, workspace: Path, config: dict):
        raise NotImplementedError("provide CSVs with events_path frame labels")

    def build_upstream(self, name: str = "fbank", **kwargs) -> SUpstream:
        return SUpstream(name, **kwargs)

    def _num_classes(self, config: dict, workspace=None) -> int:
        return int(config["num_classes"])

    def build_task(self, upstream: SUpstream, config: dict, workspace=None):
        num_classes = self._num_classes(config, workspace)
        downstream = FrameLevel(
            upstream.hidden_sizes[-1], num_classes,
            hidden_sizes=(config.get("build_downstream", {}).get("hidden_size", 256),),
        )
        module = UpstreamDownstreamModel(downstream, upstream.num_layers,
                                         **config.get("build_featurizer", {}))
        return self._event_task(module, num_classes)

    def _event_task(self, module, num_classes: int) -> EventPredictionTask:
        return EventPredictionTask(module, num_classes=num_classes)

    def _loader(self, workspace, csv_name, mode, config):
        csv_path = workspace / csv_name
        if not csv_path.exists():
            return None
        ds = _EventDataset(csv_path)
        cfg = config.get("build_batch_sampler", {})
        sampler = FixedBatchSizeBatchSampler(len(ds), cfg.get("batch_size", 8), shuffle=(mode == "train"))
        buckets = Buckets.linear(config.get("bucket_step", 16000), 16000 * 30)
        return DataLoader(ds, sampler, lambda items: pad_collate(items, buckets))

    def _trainer(self, workspace, config):
        upstream = self.build_upstream(**config.get("build_upstream", {"name": "fbank"}))
        task = self.build_task(upstream, config, workspace=workspace)
        return Trainer(
            upstream.upstream, task, workspace / "train",
            TrainerConfig(optimizer=config.get("build_optimizer", {"name": "Adam", "lr": 1e-3}),
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
        logs = trainer.evaluate(loader, mode="test")
        with open(workspace / "result.yaml", "w") as f:
            yaml.safe_dump({"test": logs}, f)
        return {"test": logs}


class HearEventExample(HearEvent):
    """Smoke test: synthesized tone-burst events."""

    def default_config(self) -> dict:
        cfg = super().default_config()
        cfg["prepare_data"] = {"num": 6}
        cfg["num_classes"] = 2
        cfg["build_downstream"] = {"hidden_size": 16}
        cfg["build_batch_sampler"] = {"batch_size": 2}
        cfg["train"] = {"total_steps": 4, "log_step": 2, "eval_step": 2, "save_step": 2}
        return cfg

    def prepare_data(self, workspace: Path, config: dict):
        from ..util.pseudo_data import _write_wav

        rng = np.random.RandomState(0)
        (workspace / "wavs").mkdir(parents=True, exist_ok=True)
        (workspace / "events").mkdir(parents=True, exist_ok=True)
        for split, n in [("train", config["prepare_data"].get("num", 6)), ("valid", 2), ("test", 2)]:
            rows = []
            for i in range(n):
                T = 16000
                wav = rng.randn(T).astype(np.float32) * 0.05
                n_frames = T // 160
                labels = np.zeros((n_frames, 2), np.int32)
                start = rng.randint(10, n_frames - 30)
                cls = i % 2
                wav[start * 160:(start + 20) * 160] += np.sin(
                    2 * np.pi * (440 if cls == 0 else 880) * np.arange(20 * 160) / 16000
                ).astype(np.float32) * 0.3
                labels[start:start + 20, cls] = 1
                wp = workspace / "wavs" / f"{split}_{i}.wav"
                ep = workspace / "events" / f"{split}_{i}.npy"
                _write_wav(wp, wav)
                np.save(ep, labels)
                rows.append(dict(id=f"{split}_{i}", wav_path=str(wp), events_path=str(ep)))
            pd.DataFrame(rows).to_csv(workspace / f"{split}.csv", index=False)


class _HearTimestampMixin:
    """HEAR timestamp-task data prep: {split or fold}.json maps clip ->
    [{"label", "start", "end"} in ms]; converted to 10 ms frame-label .npy
    files + the CSVs HearEvent consumes (reference: problem/hear/timestamp.py
    + hear_dcase_2016_task2.py:20-80)."""

    dataset_name = "hear_timestamp"
    num_folds = None
    onset_tolerance_ms = 200.0
    score_name = "event_onset_200ms_fms"
    frame_shift_ms = 10.0

    def default_config(self) -> dict:
        cfg = super().default_config()
        prep = {"task_dir": "???"}
        if self.num_folds:
            prep["test_fold"] = 0
        cfg["prepare_data"] = prep
        cfg["num_classes"] = "auto"
        cfg["build_batch_sampler"] = {"batch_size": 5}
        cfg["train"]["total_steps"] = 15000
        return cfg

    def _emit_split(self, workspace, task_dir, name, metas, vocab):
        (workspace / "events").mkdir(parents=True, exist_ok=True)
        rows = []
        for meta_name, sub in metas:
            entries = json.loads((task_dir / meta_name).read_text())
            for clip, events in entries.items():
                wav_path = task_dir / sub / clip
                shift = self.frame_shift_ms
                try:
                    dur_ms = audio_info(wav_path)["duration"] * 1000.0
                except Exception:
                    dur_ms = max((float(e["end"]) for e in events), default=1000.0)
                n_frames = max(int(dur_ms / shift), 1)
                lab = np.zeros((n_frames, len(vocab)), np.int32)
                for e in events:
                    c = vocab[str(e["label"]).strip()]
                    s = int(float(e["start"]) / shift)
                    t = max(int(float(e["end"]) / shift), s + 1)
                    lab[s : min(t, n_frames), c] = 1
                ep = workspace / "events" / f"{clip.replace('/', '-')}.npy"
                np.save(ep, lab)
                rows.append(
                    dict(id=clip.replace("/", "-"), wav_path=str(wav_path),
                         events_path=str(ep))
                )
        pd.DataFrame(rows).to_csv(workspace / f"{name}.csv", index=False)

    def prepare_data(self, workspace: Path, config: dict):
        task_dir = Path(config["prepare_data"]["task_dir"])
        audio_sub = _audio_sub(task_dir)

        def collect_vocab(meta_names):
            vocab = {}
            for m in meta_names:
                for events in json.loads((task_dir / m).read_text()).values():
                    for e in events:
                        vocab.setdefault(str(e["label"]).strip(), len(vocab))
            return vocab

        if self.num_folds:
            test_fold = int(config["prepare_data"].get("test_fold", 0))
            valid_fold = (test_fold + 1) % self.num_folds
            names = [f"fold{i:02d}.json" for i in range(self.num_folds)]
            vocab = collect_vocab(names)
            subs = {
                i: (f"{audio_sub}/fold{i:02d}"
                    if (task_dir / audio_sub / f"fold{i:02d}").exists() else audio_sub)
                for i in range(self.num_folds)
            }
            train = [(names[i], subs[i]) for i in range(self.num_folds)
                     if i not in (test_fold, valid_fold)]
            self._emit_split(workspace, task_dir, "train", train, vocab)
            self._emit_split(workspace, task_dir, "valid", [(names[valid_fold], subs[valid_fold])], vocab)
            self._emit_split(workspace, task_dir, "test", [(names[test_fold], subs[test_fold])], vocab)
        else:
            names = [f"{s}.json" for s in ("train", "valid", "test")]
            vocab = collect_vocab([n for n in names if (task_dir / n).exists()])
            for split in ("train", "valid", "test"):
                if not (task_dir / f"{split}.json").exists():
                    continue
                sub = (f"{audio_sub}/{split}"
                       if (task_dir / audio_sub / split).exists() else audio_sub)
                self._emit_split(workspace, task_dir, split, [(f"{split}.json", sub)], vocab)
        (workspace / "classes.json").write_text(json.dumps(vocab))

    def _num_classes(self, config: dict, workspace=None) -> int:
        num_classes = config.get("num_classes")
        if (num_classes in (None, "auto", "???")) and workspace is not None:
            num_classes = len(json.loads((Path(workspace) / "classes.json").read_text()))
        return int(num_classes)

    def _event_task(self, module, num_classes: int) -> EventPredictionTask:
        return EventPredictionTask(
            module, num_classes=num_classes,
            onset_tolerance_ms=self.onset_tolerance_ms,
            frame_shift_ms=self.frame_shift_ms,
            score_name=self.score_name,
        )


class HearDcase2016Task2(_HearTimestampMixin, HearEvent):
    """DCASE 2016 task 2 office sound events (hear_dcase_2016_task2.py):
    event-onset FMS at 200 ms tolerance."""

    dataset_name = "hear_dcase_2016_task2"
    onset_tolerance_ms = 200.0
    score_name = "event_onset_200ms_fms"


class HearMaestro(_HearTimestampMixin, HearEvent):
    """MAESTRO 5 hr note events, 5-fold (hear_maestro.py): onset FMS at
    50 ms tolerance."""

    dataset_name = "hear_maestro"
    num_folds = 5
    onset_tolerance_ms = 50.0
    score_name = "event_onset_50ms_fms"
