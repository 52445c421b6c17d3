"""SSL pretraining problems, the ``run_pretrain`` analog (port of
s3prl_tpu/problem/pretrain.py).

The reference's pretraining runtime (s3prl/run_pretrain.py,
pretrain/runner.py and each recipe's pretrain_expert.py / config_model.yaml):
mockingjay / tera / audio_albert mask and reconstruct mel features, apc /
vq_apc predict them autoregressively, npc reconstructs them from a masked
conv context, spec_augment from SpecAugment's bands; HuBERT predicts k-means
units of masked frames, data2vec regresses an EMA teacher's states and
DistilHuBERT a frozen HuBERT's layers.

The waves go to the card, where the features, the masks and the model run
(`ops/audio`, `ops/mam`, `ops/masking`): the Trainer's upstream is the
frozen feature front end (``mel`` / ``fbank`` / ``wav``, or the distiller's
teacher) and the task owns the trained model. Every recipe builds on the
card; a config's top-level ``device`` (e.g. ``"cpu"``) moves the front end,
and with it the task's model and the k-means of `PretrainHubert`.
"""

from __future__ import annotations

import logging
from pathlib import Path

import numpy as np
import pandas as pd
import torch
import torch.nn as nn

from .base import Problem
from ..data.collate import Buckets, pad_collate
from ..data.loader import DataLoader
from ..data.sampler import SortedBucketingSampler
from ..train.trainer import Trainer, TrainerConfig
from ..upstream.registry import _device, load as hub_load

logger = logging.getLogger(__name__)


class _AudioOnlyDataset:
    """CSV rows with wav_path (+duration); random-free (crop via end_sec)."""

    def __init__(self, csv_path, sample_rate=16000, max_secs: float = 15.0):
        self.df = pd.read_csv(csv_path)
        self.sample_rate = sample_rate
        self.max_secs = max_secs

    def __len__(self):
        return len(self.df)

    @property
    def lengths(self):
        if "duration" in self.df.columns:
            return (
                self.df["duration"].clip(upper=self.max_secs) * self.sample_rate
            ).astype(int).tolist()
        from ..data.audio import audio_info

        return [
            min(audio_info(p)["num_frames"], int(self.max_secs * self.sample_rate))
            for p in self.df["wav_path"]
        ]

    def __getitem__(self, i):
        from ..data.audio import load_wav

        row = self.df.iloc[i]
        wav, _ = load_wav(row["wav_path"], self.sample_rate, 0.0, self.max_secs)
        return {"x": wav, "unique_name": str(row["id"])}


class _HubertUnitDataset(_AudioOnlyDataset):
    """Audio + frame-level k-means unit labels (csv: wav_path, units_path)."""

    @property
    def lengths(self):
        return (
            self.df["duration"].clip(upper=self.max_secs) * self.sample_rate
        ).astype(int).tolist()

    def __getitem__(self, i):
        item = super().__getitem__(i)
        item["units"] = np.load(self.df.iloc[i]["units_path"]).astype(np.int32)
        return item


class PretrainProblem(Problem):
    """Shared staged procedure: stage 0 audio CSVs, stage 1 train."""

    STAGES = ["prepare_data", "train_stage"]

    #: which front-end upstream feeds the objective ("fbank" 240-d stacked
    #: deltas for mockingjay, "mel" 80-d log-mel for the others)
    feature_upstream = "mel"
    dataset_cls = _AudioOnlyDataset

    def prepare_data(self, workspace: Path, config: dict):
        from ..data.corpus.librispeech import prepare_librispeech_asr

        prepare_librispeech_asr(workspace, **config.get("prepare_data", {}))

    def build_task(self, config: dict):
        raise NotImplementedError

    def _loader(self, workspace, csv_name, config):
        csv_path = workspace / csv_name
        if not csv_path.exists():
            return None
        ds = self.dataset_cls(csv_path, max_secs=config.get("max_secs", 15.0))
        cfg = config.get("build_batch_sampler", {})
        sampler = SortedBucketingSampler(
            ds.lengths, batch_size=cfg.get("batch_size", 8),
            max_length=cfg.get("max_length", 16000 * 15), shuffle=True,
        )
        buckets = Buckets.linear(config.get("bucket_step", 16000), 16000 * 30)
        return DataLoader(ds, sampler, lambda items: pad_collate(items, buckets))

    def build_feature_upstream(self, config: dict):
        return hub_load(self.feature_upstream, device=config.get("device"))

    def train_stage(self, workspace: Path, config: dict):
        upstream = self.build_feature_upstream(config)
        task = self.build_task(config)
        trainer = Trainer(
            upstream, task, workspace / "train",
            TrainerConfig(
                optimizer=config.get("build_optimizer", {"name": "AdamW", "lr": 2e-4}),
                **config.get("train", {}),
            ),
        )
        trainer.train(self._loader(workspace, "train.csv", config),
                      self._loader(workspace, "valid.csv", config))
        return trainer


class MamPretrainModel(nn.Module):
    """``encoder`` (`MockingjayEncoder`) and ``head`` (`SpecPredictionHead`):
    (feats, feat_lens, generator) -> (pred [B, T, output_dim], lens)."""

    def __init__(self, enc_cfg, output_dim: int, device=None):
        super().__init__()
        from ..models.mockingjay import MockingjayEncoder, SpecPredictionHead

        self.encoder = MockingjayEncoder(enc_cfg, device=device)
        self.head = SpecPredictionHead(enc_cfg, output_dim, device=device)

    def forward(self, feats, feat_lens, generator=None):
        hs, lens = self.encoder(feats, feat_lens, generator)
        return self.head(hs[-1]), lens


class ApcPretrainModel(nn.Module):
    """``apc`` (`APCModel`): (feats, feat_lens, generator) -> (pred, lens)."""

    def __init__(self, cfg, device=None):
        super().__init__()
        from ..models.apc import APCModel

        self.apc = APCModel(cfg, device=device)

    def forward(self, feats, feat_lens, generator=None):
        _, pred, lens = self.apc(feats, feat_lens, generator)
        return pred, lens


class NpcPretrainModel(nn.Module):
    """``npc`` (`NPCModel`): (feats, feat_lens, generator) -> (pred, lens)."""

    def __init__(self, cfg, device=None):
        super().__init__()
        from ..models.npc import NPCModel

        self.npc = NPCModel(cfg, device=device)

    def forward(self, feats, feat_lens, generator=None):
        _, pred, lens = self.npc(feats, feat_lens, generator)
        return pred, lens


def _mam_task(task_cls, input_dim: int, config: dict, **enc_kwargs):
    from ..models.mockingjay import MockingjayConfig

    enc_cfg = MockingjayConfig(input_dim=input_dim, **enc_kwargs,
                               **config.get("build_model", {}))
    return task_cls(MamPretrainModel(enc_cfg, input_dim), **config.get("build_task", {}))


class PretrainMockingjay(PretrainProblem):
    """MAM on fbank80+deltas (reference: pretrain/mockingjay/config_model.yaml)."""

    feature_upstream = "fbank"
    input_dim = 240

    def default_config(self) -> dict:
        return {
            "target_dir": "???",
            "prepare_data": {"librispeech": "???", "train_split": "train-clean-100"},
            "build_model": {
                "hidden_size": 768, "num_hidden_layers": 3,
                "num_attention_heads": 12, "intermediate_size": 3072,
            },
            "build_task": {
                "loss": "L1", "mask_proportion": 0.15,
                "mask_consecutive": 7, "mask_frequency": 0.0,
            },
            "build_batch_sampler": {"batch_size": 8},
            "build_optimizer": {"name": "AdamW", "lr": 2.0e-4},
            "train": {"total_steps": 1000000, "log_step": 100, "eval_step": 10000, "save_step": 10000},
        }

    def build_task(self, config: dict):
        from ..task.reconstruction import MaskedReconstructionTask

        return _mam_task(MaskedReconstructionTask, self.input_dim, config)


class PretrainTera(PretrainMockingjay):
    """MAM + frequency masking on log-mel (pretrain/tera/config_model.yaml)."""

    feature_upstream = "mel"
    input_dim = 80

    def default_config(self) -> dict:
        cfg = super().default_config()
        cfg["build_task"]["mask_frequency"] = 0.2
        return cfg


class PretrainAudioAlbert(PretrainTera):
    """Weight-shared TERA (pretrain/audio_albert/config_model.yaml)."""

    def build_task(self, config: dict):
        from ..task.reconstruction import MaskedReconstructionTask

        return _mam_task(MaskedReconstructionTask, self.input_dim, config, share_layer=True)


class PretrainAPC(PretrainProblem):
    """Autoregressive predictive coding (reference: pretrain/apc)."""

    feature_upstream = "mel"

    def default_config(self) -> dict:
        return {
            "target_dir": "???",
            "prepare_data": {"librispeech": "???", "train_split": "train-clean-100"},
            "build_model": {"input_size": 80, "hidden_size": 512, "num_layers": 3},
            "build_task": {"n_future": 5, "loss": "L1"},
            "build_batch_sampler": {"batch_size": 32},
            "build_optimizer": {"name": "Adam", "lr": 1.0e-3},
            "train": {"total_steps": 100000, "log_step": 100, "eval_step": 10000, "save_step": 10000},
        }

    def build_task(self, config: dict):
        from ..models.apc import APCConfig
        from ..task.reconstruction import AutoregressiveReconstructionTask

        mc = dict(config.get("build_model", {}))
        for key in ("vq_codebook_size", "vq_code_dim"):
            if mc.get(key) is not None and not isinstance(mc[key], tuple):
                mc[key] = tuple(mc[key])
        return AutoregressiveReconstructionTask(ApcPretrainModel(APCConfig(**mc)),
                                                **config.get("build_task", {}))


class PretrainVqApc(PretrainAPC):
    """VQ-APC: APC with gumbel-softmax codebooks between GRU layers
    (reference: pretrain/vq_apc/config_model.yaml)."""

    def default_config(self) -> dict:
        cfg = super().default_config()
        cfg["build_model"].update(vq_codebook_size=(512,), vq_code_dim=(512,))
        return cfg


class PretrainNPC(PretrainProblem):
    """Non-autoregressive predictive coding: reconstruct each frame from a
    masked conv context (reference: pretrain/npc/config_model.yaml)."""

    feature_upstream = "mel"

    def default_config(self) -> dict:
        return {
            "target_dir": "???",
            "prepare_data": {"librispeech": "???", "train_split": "train-clean-100"},
            "build_model": {
                "input_size": 80, "hidden_size": 512, "n_blocks": 4,
                "kernel_size": 15, "mask_size": 5,
            },
            "build_task": {"loss": "L1"},
            "build_batch_sampler": {"batch_size": 32},
            "build_optimizer": {"name": "Adam", "lr": 1.0e-3},
            "train": {"total_steps": 100000, "log_step": 100, "eval_step": 10000, "save_step": 10000},
        }

    def build_task(self, config: dict):
        from ..models.npc import NPCConfig
        from ..task.reconstruction import NpcReconstructionTask

        return NpcReconstructionTask(NpcPretrainModel(NPCConfig(**config.get("build_model", {}))),
                                     **config.get("build_task", {}))


class PretrainSpecAugment(PretrainProblem):
    """SpecAugment-corruption pretraining: reconstruct LD-policy-masked
    cells (reference: pretrain/spec_augment/pretrain_expert.py + task.py)."""

    feature_upstream = "fbank"
    input_dim = 240

    def default_config(self) -> dict:
        return {
            "target_dir": "???",
            "prepare_data": {"librispeech": "???", "train_split": "train-clean-100"},
            "build_model": {
                "hidden_size": 768, "num_hidden_layers": 3,
                "num_attention_heads": 12, "intermediate_size": 3072,
            },
            "build_task": {
                "loss": "L1", "freq_mask_width": 27, "freq_mask_num": 2,
                "time_mask_width": 100, "time_mask_num": 2,
            },
            "build_batch_sampler": {"batch_size": 8},
            "build_optimizer": {"name": "AdamW", "lr": 2.0e-4},
            "train": {"total_steps": 1000000, "log_step": 100, "eval_step": 10000, "save_step": 10000},
        }

    def build_task(self, config: dict):
        from ..task.reconstruction import SpecAugReconstructionTask

        return _mam_task(SpecAugReconstructionTask, self.input_dim, config)


class PretrainDistiller(PretrainProblem):
    """DistilHuBERT: distill a frozen teacher's layers into a 2-layer
    student (reference: pretrain/distiller/config_model.yaml). The teacher
    rides as the Trainer's frozen upstream."""

    def default_config(self) -> dict:
        return {
            "target_dir": "???",
            "prepare_data": {"librispeech": "???", "train_split": "train-clean-100"},
            "teacher": {"name": "hubert", "ckpt": None},
            "build_model": {
                "encoder_layers": 2, "encoder_embed_dim": 768,
                "encoder_ffn_embed_dim": 3072, "encoder_attention_heads": 12,
                "final_dim": 768, "n_tasks": 3,
            },
            "build_task": {
                "pred_layer_id": [4, 8, 12], "loss_type": "l1", "cosine_loss": 1.0,
            },
            "build_batch_sampler": {"batch_size": 12},
            "build_optimizer": {"name": "AdamW", "lr": 2.0e-4},
            "train": {"total_steps": 200000, "log_step": 100, "eval_step": 10000, "save_step": 10000},
        }

    def build_feature_upstream(self, config: dict):
        teacher = config.get("teacher", {"name": "hubert"})
        return hub_load(teacher.get("name", "hubert"), ckpt=teacher.get("ckpt"),
                        device=config.get("device"))

    def build_task(self, config: dict):
        from ..models.distiller import DistillerConfig, DistillerModel
        from ..task.distiller_pretrain import DistillerPretrainTask

        mc = dict(config.get("build_model", {}))
        if "conv_feature_layers" in mc and not isinstance(mc["conv_feature_layers"], tuple):
            mc["conv_feature_layers"] = tuple(tuple(c) for c in mc["conv_feature_layers"])
        cfg = DistillerConfig(**mc)
        tc = dict(config.get("build_task", {}))
        tc.setdefault("pred_layer_id", list(range(1, cfg.n_tasks + 1)))
        return DistillerPretrainTask(DistillerModel(cfg), n_tasks=cfg.n_tasks, **tc)


def _write_pseudo_split(workspace: Path, rng, split: str, n: int, secs_range, units=None):
    """`n` pseudo waves (0.1 x N(0, 1), durations uniform in `secs_range`)
    under workspace/wavs and their CSV; with `units` (classes) a random
    label a 320 samples under workspace/units, drawn after each wave."""
    from ..util.pseudo_data import _write_wav

    rows = []
    for i in range(n):
        secs = float(rng.uniform(*secs_range))
        wav = (rng.randn(int(16000 * secs)) * 0.1).astype(np.float32)
        path = workspace / "wavs" / f"{split}_{i}.wav"
        _write_wav(path, wav)
        row = dict(id=f"{split}_{i}", wav_path=str(path))
        if units is not None:
            upath = workspace / "units" / f"{split}_{i}.npy"
            np.save(upath, rng.randint(0, units, size=len(wav) // 320).astype(np.int32))
            row["units_path"] = str(upath)
        rows.append({**row, "duration": secs})
    pd.DataFrame(rows).to_csv(workspace / f"{split}.csv", index=False)


class PretrainExample(PretrainTera):
    """Smoke-test pretraining on pseudo audio (integration-test artifact)."""

    def default_config(self) -> dict:
        cfg = super().default_config()
        cfg["prepare_data"] = {"num_train": 8, "num_valid": 4}
        cfg["build_model"] = {
            "hidden_size": 64, "num_hidden_layers": 2,
            "num_attention_heads": 4, "intermediate_size": 128,
        }
        cfg["train"] = {"total_steps": 4, "log_step": 2, "eval_step": 2, "save_step": 2}
        cfg["build_batch_sampler"] = {"batch_size": 4}
        return cfg

    def prepare_data(self, workspace: Path, config: dict):
        cfg = config.get("prepare_data", {})
        rng = np.random.RandomState(0)
        (workspace / "wavs").mkdir(parents=True, exist_ok=True)
        for split, n in [("train", cfg.get("num_train", 8)), ("valid", cfg.get("num_valid", 4))]:
            _write_pseudo_split(workspace, rng, split, n, (0.5, 2.0))


class PretrainHubert(PretrainProblem):
    """HuBERT masked-unit pretraining (reference: the fairseq recipe the
    converted HuBERT checkpoints come from; loss per hubert_model.py:465-560).

    The iteration-1 loop is self-contained: `prepare_units` discovers the
    targets with `ops/kmeans.py` on the card (39-d MFCC at 10 ms, no CMVN,
    subsampled to the trunk's 20 ms) in place of fairseq's dump-MFCC ->
    sklearn-MiniBatchKMeans -> dump-label pipeline. Precomputed labels
    still work: point ``prepare_units.units_dir`` at <id>.npy files, or
    write ``units_path`` columns in prepare_data and the stage no-ops.
    Iteration 2 (re-label with a trained trunk's states): dump features with
    `task.dump_feature` and cluster them."""

    feature_upstream = "wav"
    dataset_cls = _HubertUnitDataset
    STAGES = ["prepare_data", "prepare_units", "train_stage"]

    def default_config(self) -> dict:
        return {
            "target_dir": "???",
            "prepare_data": {"librispeech": "???", "train_split": "train-clean-100"},
            "prepare_units": {"num_clusters": 100, "iters": 20,
                              "max_fit_frames": 1_000_000},
            "build_model": {},
            "build_task": {"mask_prob": 0.8, "mask_length": 10},
            "build_batch_sampler": {"batch_size": 8},
            "build_optimizer": {"name": "AdamW", "lr": 5.0e-4, "scheduler": "linear_schedule"},
            "train": {"total_steps": 400000, "log_step": 100, "eval_step": 10000, "save_step": 10000},
        }

    def prepare_units(self, workspace: Path, config: dict):
        """Discover (or attach) frame-level unit labels for every CSV row:
        39-d MFCC (13 ceps + deltas to order 2, no CMVN: fairseq's
        dump_mfcc applies none, and it would erase the spectral identity
        k-means clusters) of each wave padded to whole seconds, every
        ``frame_subsample``-th frame; `kmeans_fit` on the first
        ``max_fit_frames`` of train.csv, the init drawn from seed 0; one
        ``units/<id>.npy`` an utterance and ``units/centroids.npy``."""
        from ..data.audio import load_wav
        from ..models.baseline import baseline_features
        from ..ops.kmeans import kmeans_assign, kmeans_fit, kmeans_inertia

        cfg = dict(config.get("prepare_units", {}))
        csvs = [p for p in (workspace / "train.csv", workspace / "valid.csv") if p.exists()]
        dfs = {p: pd.read_csv(p) for p in csvs}
        if all("units_path" in df.columns for df in dfs.values()):
            return  # labels shipped by prepare_data: nothing to discover
        units_dir_cfg = cfg.get("units_dir")
        if units_dir_cfg:  # precomputed fairseq-style label dir
            for p, df in dfs.items():
                df["units_path"] = [str(Path(units_dir_cfg) / f"{i}.npy") for i in df["id"]]
                df.to_csv(p, index=False)
            return

        num_clusters = int(cfg.get("num_clusters", 100))
        iters = int(cfg.get("iters", 20))
        max_fit = int(cfg.get("max_fit_frames", 1_000_000))
        sub = int(cfg.get("frame_subsample", 2))  # 10 ms MFCC -> 20 ms units
        max_secs = float(cfg.get("max_secs", 15.0))
        device = _device(config.get("device"))
        out_dir = workspace / "units"
        out_dir.mkdir(parents=True, exist_ok=True)

        @torch.no_grad()
        def mfcc_of(path):
            wav, _ = load_wav(path, 16000, 0.0, max_secs)
            T = max(len(wav), 400)
            Tp = -(-T // 16000) * 16000
            w = torch.from_numpy(np.pad(wav, (0, Tp - len(wav)))).to(device)[None]
            f, fl = baseline_features(w, torch.tensor([T], device=device), feat_type="mfcc",
                                      num_ceps=13, delta_order=2, cmvn=False)
            return f[0, : int(fl[0])][::sub].float()

        fit_chunks, fit_frames = [], 0
        for _, row in dfs[csvs[0]].iterrows():
            if fit_frames >= max_fit:
                break
            f = mfcc_of(row["wav_path"])
            fit_chunks.append(f)
            fit_frames += len(f)
        sample = torch.cat(fit_chunks)[:max_fit]
        centroids = kmeans_fit(torch.Generator().manual_seed(0), sample, num_clusters,
                               iters=iters)
        np.save(out_dir / "centroids.npy", centroids.cpu().numpy())
        logger.info(f"k-means fit on {len(sample)} frames: inertia "
                    f"{kmeans_inertia(sample, centroids):.3f}")
        for p, df in dfs.items():
            paths = []
            for _, row in df.iterrows():
                units = kmeans_assign(mfcc_of(row["wav_path"]), centroids)
                upath = out_dir / f"{row['id']}.npy"
                np.save(upath, units.cpu().numpy().astype(np.int32))
                paths.append(str(upath))
            df["units_path"] = paths
            df.to_csv(p, index=False)

    def build_task(self, config: dict):
        from ..models.hubert import HUBERT_BASE, HubertForPretrain, HubertPretrainConfig
        from ..task.hubert_pretrain import HubertPretrainTask

        model_cfg = dict(config.get("build_model", {}))
        num_classes = model_cfg.pop("num_classes", 504)
        module = HubertForPretrain(cfg=HUBERT_BASE,
                                   pre_cfg=HubertPretrainConfig(num_classes=num_classes),
                                   **model_cfg)
        return HubertPretrainTask(module, **config.get("build_task", {}))


def _tiny_trunk():
    """The Example recipes' trunk: five convs of 32 channels (stride 320),
    two layers of width 32, dropouts 0 (the JAX Examples' config)."""
    from ..models.wav2vec2 import Wav2Vec2Config

    return Wav2Vec2Config(
        conv_feature_layers=((32, 10, 5), (32, 4, 4), (32, 4, 4), (32, 2, 2), (32, 2, 2)),
        encoder_layers=2, encoder_embed_dim=32,
        encoder_ffn_embed_dim=64, encoder_attention_heads=4,
        dropout=0.0, attention_dropout=0.0, dropout_input=0.0,
    )


class PretrainHubertExample(PretrainHubert):
    """Smoke-test HuBERT pretraining: pseudo audio + random units, tiny trunk."""

    def default_config(self) -> dict:
        cfg = super().default_config()
        cfg["prepare_data"] = {"num_train": 6, "num_valid": 2}
        cfg["build_model"] = {"num_classes": 16}
        cfg["build_batch_sampler"] = {"batch_size": 2}
        cfg["train"] = {"total_steps": 2, "log_step": 1, "eval_step": 10**9, "save_step": 2}
        return cfg

    def build_task(self, config: dict):
        from ..models.hubert import HubertForPretrain, HubertPretrainConfig
        from ..task.hubert_pretrain import HubertPretrainTask

        module = HubertForPretrain(cfg=_tiny_trunk(),
                                   pre_cfg=HubertPretrainConfig(num_classes=16, final_dim=16))
        return HubertPretrainTask(module, **config.get("build_task", {}))

    def prepare_data(self, workspace: Path, config: dict):
        cfg = config.get("prepare_data", {})
        rng = np.random.RandomState(0)
        (workspace / "wavs").mkdir(parents=True, exist_ok=True)
        (workspace / "units").mkdir(parents=True, exist_ok=True)
        for split, n in [("train", cfg.get("num_train", 6)), ("valid", cfg.get("num_valid", 2))]:
            _write_pseudo_split(workspace, rng, split, n, (0.5, 1.5), units=16)


class PretrainData2Vec(PretrainProblem):
    """data2vec audio pretraining (EMA teacher; reference: upstream/data2vec)."""

    feature_upstream = "wav"

    def default_config(self) -> dict:
        return {
            "target_dir": "???",
            "prepare_data": {"librispeech": "???", "train_split": "train-clean-100"},
            "build_model": {},
            "build_task": {
                "average_top_k_layers": 8, "ema_decay": 0.999,
                "mask_prob": 0.65, "mask_length": 10,
            },
            "build_batch_sampler": {"batch_size": 8},
            "build_optimizer": {"name": "Adam", "lr": 5.0e-4, "scheduler": "linear_schedule"},
            "train": {"total_steps": 400000, "log_step": 100, "eval_step": 10000, "save_step": 10000},
        }

    def build_task(self, config: dict):
        from ..models.wav2vec2 import Wav2Vec2Trunk
        from ..task.data2vec_pretrain import Data2VecPretrainTask
        from ..upstream.registry import DATA2VEC_BASE

        cfg = config.get("build_model", {}).get("cfg", DATA2VEC_BASE)
        return Data2VecPretrainTask(Wav2Vec2Trunk(cfg), **config.get("build_task", {}))


class PretrainData2VecExample(PretrainData2Vec):
    """Smoke test: tiny trunk, pseudo audio, EMA teacher must move."""

    def default_config(self) -> dict:
        cfg = super().default_config()
        cfg["prepare_data"] = {"num_train": 6, "num_valid": 2}
        cfg["build_task"] = {"average_top_k_layers": 2, "ema_decay": 0.9,
                             "mask_prob": 0.65, "mask_length": 4}
        cfg["build_batch_sampler"] = {"batch_size": 2}
        cfg["train"] = {"total_steps": 2, "log_step": 1, "eval_step": 10**9, "save_step": 2}
        return cfg

    def build_task(self, config: dict):
        from ..models.wav2vec2 import Wav2Vec2Trunk
        from ..task.data2vec_pretrain import Data2VecPretrainTask

        return Data2VecPretrainTask(Wav2Vec2Trunk(_tiny_trunk()), **config.get("build_task", {}))

    def prepare_data(self, workspace: Path, config: dict):
        PretrainExample.prepare_data(self, workspace, config)
