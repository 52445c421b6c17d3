"""Utterance-classification problems: SID / KS / IC / ER (+ smoke-test
recipes) (port of s3prl_tpu/problem/common.py).

Behavioral spec from the reference's Common run procedure
(s3prl/problem/common/run.py:26-318) and recipe defaults
(superb_sid.py:103-148, superb_ks.py:176-195, superb_ic.py:137-156,
superb_er.py:188-207): stage 0 prepare_data -> CSVs, stage 1 category
encoder, stage 2 frozen-upstream weighted-sum training, stage 3 evaluate
every test CSV into result.yaml.

The recipes' default upstream is ``fbank`` (the Kaldi baseline front end,
`models/baseline.py`, on the card); a run may name a trunk entry in
``build_upstream``, e.g. ``{"name": "hubert_large_ll60k", "extra_conf":
{"dtype": "bf16", "flash": True, "quantize": True}}`` (``extra_conf`` also
takes ``device="cpu"``). `CommonProblem.inference`
predicts one WAV or FLAC file with the trained probe (the legacy ``-m
inference``).
"""

from __future__ import annotations

import json
import logging
from pathlib import Path
from typing import Optional

import numpy as np
import pandas as pd
import torch
import yaml

from .base import Problem
from ..data.audio import load_wav
from ..data.collate import Buckets, pad_collate
from ..data.dataset import UtteranceClassificationDataset, UtteranceMultiClassDataset
from ..data.encoder import CategoryEncoder, CategoryEncoders
from ..data.loader import DataLoader
from ..data.sampler import BalancedWeightedSampler, FixedBatchSizeBatchSampler
from ..nn.heads import UtteranceLevel
from ..nn.upstream import SUpstream, UpstreamDownstreamModel
from ..task.utterance_classification import (UtteranceClassificationTask,
                                             UtteranceMultiClassClassificationTask)
from ..train import checkpoint as ckpt
from ..train.trainer import Trainer, TrainerConfig

logger = logging.getLogger(__name__)


class CommonProblem(Problem):
    """Shared staged procedure for single-label utterance classification."""

    STAGES = ["prepare_data", "build_encoder", "train_stage", "evaluate_stage"]

    # ---- stage 0: per-recipe ------------------------------------------------
    def prepare_data(self, workspace: Path, config: dict):
        """Write train.csv / valid.csv / test.csv into the workspace."""
        raise NotImplementedError

    # ---- stage 1 -------------------------------------------------------------
    def build_encoder(self, workspace: Path, config: dict) -> CategoryEncoder:
        df = pd.read_csv(workspace / "train.csv")
        encoder = CategoryEncoder(df["label"].astype(str))
        encoder.save(workspace / "encoder.json")
        return encoder

    def load_encoder(self, workspace: Path):
        return CategoryEncoder.load(workspace / "encoder.json")

    # ---- builders ("config keys = builder kwargs") ---------------------------
    def build_upstream(self, name: str = "fbank", **kwargs) -> SUpstream:
        return SUpstream(name, **kwargs)

    def build_downstream(self, input_size: int, output_size: int, hidden_size: int = 256,
                         pooling: str = "MeanPooling"):
        return UtteranceLevel(input_size, output_size, hidden_sizes=(hidden_size,),
                              pooling=pooling)

    def _module(self, upstream: SUpstream, output_size: int, config: dict):
        downstream = self.build_downstream(
            upstream.hidden_sizes[-1], output_size, **config.get("build_downstream", {}))
        return UpstreamDownstreamModel(downstream, upstream.num_layers,
                                       **config.get("build_featurizer", {}))

    def build_task(self, upstream: SUpstream, encoder: CategoryEncoder, config: dict):
        return UtteranceClassificationTask(self._module(upstream, len(encoder), config),
                                           num_classes=len(encoder))

    def build_dataset(self, csv_path, encoder: CategoryEncoder):
        return UtteranceClassificationDataset(csv_path, encoder)

    def build_batch_sampler(self, dataset, mode: str, config: dict):
        cfg = dict(config.get("build_batch_sampler", {}))
        batch_size = cfg.get("batch_size", 8)
        if mode == "train" and cfg.get("balanced", False):
            return BalancedWeightedSampler(
                [dataset.df.iloc[i]["label"] for i in range(len(dataset))], batch_size
            )
        return FixedBatchSizeBatchSampler(len(dataset), batch_size, shuffle=(mode == "train"))

    def _loader(self, workspace, csv_name: str, encoder, mode: str, config: dict) -> Optional[DataLoader]:
        csv_path = workspace / csv_name
        if not csv_path.exists():
            return None
        ds = self.build_dataset(csv_path, encoder)
        sampler = self.build_batch_sampler(ds, mode, config)
        buckets = Buckets.linear(
            config.get("bucket_step", 16000), config.get("bucket_max", 16000 * 30)
        )
        return DataLoader(ds, sampler, lambda items: pad_collate(items, buckets),
                          distribute=mode == "train")

    def _trainer(self, workspace: Path, config: dict):
        encoder = self.load_encoder(workspace)
        upstream = self.build_upstream(**config.get("build_upstream", {}))
        task = self.build_task(upstream, encoder, config)
        trainer = Trainer(
            upstream.upstream, task, workspace / "train",
            TrainerConfig(optimizer=config.get("build_optimizer", {"name": "Adam", "lr": 1e-4}),
                          **config.get("train", {})),
        )
        return trainer, encoder

    # ---- stage 2 -------------------------------------------------------------
    def train_stage(self, workspace: Path, config: dict):
        trainer, encoder = self._trainer(workspace, config)
        train_loader = self._loader(workspace, "train.csv", encoder, "train", config)
        valid_loader = self._loader(workspace, "valid.csv", encoder, "valid", config)
        trainer.train(train_loader, valid_loader)
        return trainer

    # ---- single-file inference (legacy -m inference, runner.py:506-524) ------
    def inference(self, workspace: Path, config: dict, wav_path: str):
        """Predicts one WAV or FLAC file with the trained probe (valid_best,
        else the newest step) on the frozen upstream; prints ``<name>
        <prediction>`` and appends it to the workspace's inference.txt."""
        workspace = Path(workspace)
        encoder = self.load_encoder(workspace)
        upstream = self.build_upstream(**config.get("build_upstream", {}))
        task = self.build_task(upstream, encoder, config)
        best = workspace / "train" / "valid_best"
        load_dir = best if best.exists() else ckpt.latest_checkpoint(workspace / "train")
        if load_dir is None:
            raise FileNotFoundError(f"no checkpoint under {workspace / 'train'}")
        up = upstream.upstream
        module = task.module.to(up.device).eval()
        module.load_state_dict(ckpt.load_checkpoint(load_dir, up.device)[0])
        wav, _sr = load_wav(wav_path, target_sample_rate=16000)
        x = torch.from_numpy(np.asarray(wav, np.float32).reshape(1, -1)).to(up.device)
        with torch.no_grad():
            hs, h_lens = up(x, torch.tensor([x.shape[1]], device=up.device))
            logits = module(hs, h_lens)
        if isinstance(logits, tuple):  # frame-level heads return (logits, lens)
            logits = logits[0]
        pred = self._decode_prediction(encoder, logits.float().cpu().numpy())
        name = Path(wav_path).stem
        print(f"{name} {pred}")
        with open(workspace / "inference.txt", "a") as f:
            f.write(f"{name} {pred}\n")
        return pred

    def _decode_prediction(self, encoder, logits) -> str:
        return encoder.decode(int(np.argmax(logits[0])))

    # ---- stage 3 -------------------------------------------------------------
    def evaluate_stage(self, workspace: Path, config: dict):
        trainer, encoder = self._trainer(workspace, config)
        results = {}
        for csv_path in sorted(workspace.glob("test*.csv")):
            loader = self._loader(workspace, csv_path.name, encoder, "test", config)
            trainer.init(resume=False)
            best = workspace / "train" / "valid_best"
            load_dir = best if best.exists() else ckpt.latest_checkpoint(workspace / "train")
            if load_dir is not None:
                model_state, _, _ = ckpt.load_checkpoint(load_dir, trainer.device)
                trainer.task.module.load_state_dict(model_state)
            results[csv_path.stem] = trainer.evaluate(loader, mode=f"test-{csv_path.stem}")
        with open(workspace / "result.yaml", "w") as f:
            yaml.safe_dump(results, f)
        return results


# ---------------------------------------------------------------------------
# recipes (defaults from SURVEY.md appendix A / the reference recipe files)
# ---------------------------------------------------------------------------


class SuperbSID(CommonProblem):
    """Speaker id on VoxCeleb1 (reference: problem/common/superb_sid.py:103-148)."""

    def default_config(self) -> dict:
        return {
            "target_dir": "???",
            "prepare_data": {"voxceleb1": "???"},
            "build_upstream": {"name": "fbank"},
            "build_downstream": {"hidden_size": 256},
            "build_batch_sampler": {"batch_size": 8},
            "build_optimizer": {"name": "Adam", "lr": 1.0e-4},
            "train": {
                "total_steps": 200000,
                "log_step": 500,
                "eval_step": 5000,
                "save_step": 1000,
                "gradient_clipping": 1.0,
                "gradient_accumulate": 4,
            },
        }

    def prepare_data(self, workspace: Path, config: dict):
        from ..data.corpus.voxceleb1 import prepare_voxceleb1_sid

        return prepare_voxceleb1_sid(workspace, **config.get("prepare_data", {}))


class SuperbKS(CommonProblem):
    """Keyword spotting on Speech Commands (reference: superb_ks.py:176-195)."""

    def default_config(self) -> dict:
        cfg = SuperbSID.default_config(self)
        cfg["prepare_data"] = {"speech_commands": "???"}
        cfg["build_batch_sampler"] = {"batch_size": 32, "balanced": True}
        cfg["train"]["gradient_accumulate"] = 1
        return cfg

    def prepare_data(self, workspace: Path, config: dict):
        from ..data.corpus.speech_commands import prepare_speech_commands

        return prepare_speech_commands(workspace, **config.get("prepare_data", {}))


class SuperbER(CommonProblem):
    """Emotion recognition on IEMOCAP 5-fold (reference: superb_er.py:188-207)."""

    def default_config(self) -> dict:
        cfg = SuperbSID.default_config(self)
        cfg["prepare_data"] = {"iemocap": "???", "test_fold": 1}
        # batch 4 x accum 8 (superb_er.py:164,205; legacy emotion/config.yaml
        # train_batch_size 4 / gradient_accumulate_steps 8)
        cfg["build_batch_sampler"] = {"batch_size": 4}
        cfg["train"]["total_steps"] = 30000
        cfg["train"]["gradient_accumulate"] = 8
        return cfg

    def prepare_data(self, workspace: Path, config: dict):
        from ..data.corpus.iemocap import prepare_iemocap

        return prepare_iemocap(workspace, **config.get("prepare_data", {}))


class SuperbIC(CommonProblem):
    """Intent classification on Fluent Speech Commands (superb_ic.py:137-156)."""

    LABEL_COLUMNS = ["action", "object", "location"]

    def default_config(self) -> dict:
        cfg = SuperbSID.default_config(self)
        cfg["prepare_data"] = {"fluent_speech_commands": "???"}
        # batch 32 (superb_ic.py:113; legacy fluent_commands/config.yaml)
        cfg["build_batch_sampler"] = {"batch_size": 32}
        cfg["train"]["gradient_accumulate"] = 1
        return cfg

    def prepare_data(self, workspace: Path, config: dict):
        from ..data.corpus.fluent_commands import prepare_fluent_commands

        return prepare_fluent_commands(workspace, **config.get("prepare_data", {}))

    def build_encoder(self, workspace: Path, config: dict):
        df = pd.read_csv(workspace / "train.csv")
        encoders = CategoryEncoders([df[c].astype(str) for c in self.LABEL_COLUMNS])
        (workspace / "encoder.json").write_text(
            json.dumps([e.category for e in encoders.encoders])
        )
        return encoders

    def load_encoder(self, workspace: Path):
        return CategoryEncoders(json.loads((workspace / "encoder.json").read_text()))

    def build_task(self, upstream, encoders, config: dict):
        sizes = tuple(len(e) for e in encoders.encoders)
        return UtteranceMultiClassClassificationTask(
            self._module(upstream, sum(sizes), config), sizes)

    def build_dataset(self, csv_path, encoders):
        return UtteranceMultiClassDataset(csv_path, encoders, self.LABEL_COLUMNS)


class CommonExample(CommonProblem):
    """Smoke-test recipe on pseudo audio (reference: problem/common/example.py).

    Generates deterministic noise wavs with random labels; runs all stages
    in seconds on a tiny upstream (its default, ``fbank``, or any entry
    in ``build_upstream``).
    """

    def default_config(self) -> dict:
        return {
            "target_dir": "???",
            "prepare_data": {"num_train": 10, "num_valid": 4, "num_test": 4},
            "build_upstream": {"name": "fbank"},
            "build_downstream": {"hidden_size": 32},
            "build_batch_sampler": {"batch_size": 4},
            "build_optimizer": {"name": "Adam", "lr": 1.0e-3},
            "bucket_step": 16000,
            "train": {
                "total_steps": 4,
                "log_step": 2,
                "eval_step": 2,
                "save_step": 2,
            },
        }

    def prepare_data(self, workspace: Path, config: dict):
        import numpy as np

        from ..util.pseudo_data import _write_wav

        cfg = config.get("prepare_data", {})
        rng = np.random.RandomState(0)
        wav_dir = workspace / "wavs"
        wav_dir.mkdir(parents=True, exist_ok=True)
        labels = ["alpha", "beta", "gamma"]
        for split, n in [
            ("train", cfg.get("num_train", 10)),
            ("valid", cfg.get("num_valid", 4)),
            ("test", cfg.get("num_test", 4)),
        ]:
            rows = []
            for i in range(n):
                secs = float(rng.uniform(0.5, 2.0))
                wav = (rng.randn(int(16000 * secs)) * 0.1).astype(np.float32)
                path = wav_dir / f"{split}_{i}.wav"
                _write_wav(path, wav)
                rows.append(
                    dict(id=f"{split}_{i}", wav_path=str(path),
                         label=labels[i % len(labels)], duration=secs)
                )
            pd.DataFrame(rows).to_csv(workspace / f"{split}.csv", index=False)


class IcExample(SuperbIC):
    """Smoke-test multi-head intent classification on pseudo audio."""

    def default_config(self) -> dict:
        cfg = super().default_config()
        cfg["prepare_data"] = {"num_train": 8, "num_valid": 4, "num_test": 4}
        cfg["build_downstream"] = {"hidden_size": 16}
        cfg["build_batch_sampler"] = {"batch_size": 4}
        cfg["train"] = {"total_steps": 4, "log_step": 2, "eval_step": 2, "save_step": 2}
        return cfg

    def prepare_data(self, workspace: Path, config: dict):
        import numpy as np

        from ..util.pseudo_data import _write_wav

        cfg = config.get("prepare_data", {})
        rng = np.random.RandomState(0)
        wav_dir = workspace / "wavs"
        wav_dir.mkdir(parents=True, exist_ok=True)
        actions, objects, locations = ["on", "off"], ["lights", "music"], ["kitchen", "none"]
        for split, n in [("train", cfg.get("num_train", 8)), ("valid", cfg.get("num_valid", 4)), ("test", cfg.get("num_test", 4))]:
            rows = []
            for i in range(n):
                wav = (rng.randn(int(16000 * rng.uniform(0.4, 0.8))) * 0.1).astype(np.float32)
                p = wav_dir / f"{split}_{i}.wav"
                _write_wav(p, wav)
                rows.append(dict(id=f"{split}_{i}", wav_path=str(p),
                                 action=actions[i % 2], object=objects[(i // 2) % 2],
                                 location=locations[i % 2]))
            pd.DataFrame(rows).to_csv(workspace / f"{split}.csv", index=False)
