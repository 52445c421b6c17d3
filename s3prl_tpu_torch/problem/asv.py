"""Speaker verification problems, SUPERB ASV (port of s3prl_tpu/problem/
asv.py).

Behavioral spec from the reference (s3prl/problem/asv/run.py:27 +
superb_asv.py:134-151): stage 0 VoxCeleb1 train/test CSVs + trial list,
stage 1 speaker category encoder, stage 2 x-vector + AM-softmax training
(AdamW 1e-4, grad clip 1e3, accum 5, no mid-train valid), stage 3 embed
every test utterance and reduce the trials' cosine scores to EER / minDCF.
The legacy variants: GE2E (SAP embedder, speaker-grouped batches, 5-s
training crops) and AM-softmax with segment evaluation (8-s windows at a
4-s stride, the mean of the unit-normalised segment embeddings).

Stage 3 loads the newest step (``ckpt.latest_checkpoint``), as the JAX
recipes do. It embeds VoxCeleb1's test speakers, which training never sees
and the encoder does not hold: the port gives them class id -1
(`SpeakerDataset`; the JAX recipes' dataset raises a KeyError there, so
their stage 3 runs only where the test speakers are training speakers, as
in the Example recipes). The recipes' default upstream (``fbank``) is not
ported: a run names a trunk entry in ``build_upstream``. As in the JAX
package, the loaders pad to 1-s buckets of at most ``bucket_max`` samples
(30 s by default), and a longer utterance fails the collation: VoxCeleb1's
test split needs a larger ``bucket_max``.
"""

from __future__ import annotations

import logging
from pathlib import Path

import numpy as np
import pandas as pd
import yaml

from .common import CommonProblem
from ..data.dataset import UtteranceClassificationDataset
from ..data.encoder import CategoryEncoder
from ..data.sampler import FixedBatchSizeBatchSampler, GE2EBatchSampler
from ..nn.speaker import SapSpeakerHead, SuperbXvector
from ..nn.upstream import SUpstream, UpstreamDownstreamModel
from ..task.speaker_verification import Ge2eVerificationTask, SpeakerVerificationTask
from ..train import checkpoint as ckpt
from ..train.trainer import _split_batch

logger = logging.getLogger(__name__)


class SpeakerDataset(UtteranceClassificationDataset):
    """UtteranceClassificationDataset whose speakers unknown to the encoder
    get class id -1 (stage 3 reads no class id)."""

    def __getitem__(self, i: int) -> dict:
        row = self.df.iloc[i]
        label = str(row["label"])
        try:
            class_id = int(self.encoder.encode(label))
        except KeyError:
            class_id = -1
        return {"x": self._load_wav(row), "class_id": class_id, "label": label,
                "unique_name": str(row["id"])}


class SuperbASV(CommonProblem):
    def default_config(self) -> dict:
        return {
            "target_dir": "???",
            "prepare_data": {"voxceleb1": "???"},
            "build_upstream": {"name": "fbank"},
            "build_downstream": {"output_size": 512, "hidden_size": 512},
            "build_batch_sampler": {"batch_size": 10},
            "build_optimizer": {"name": "AdamW", "lr": 1.0e-4},
            "train": {
                "total_steps": 200000,
                "log_step": 500,
                "eval_step": 10**9,  # no mid-train valid (superb_asv.py:141)
                "save_step": 10000,
                "gradient_clipping": 1000.0,
                "gradient_accumulate": 5,
            },
        }

    def prepare_data(self, workspace: Path, config: dict):
        from ..data.corpus.voxceleb1 import prepare_voxceleb1_sv

        return prepare_voxceleb1_sv(workspace, **config.get("prepare_data", {}))

    def build_task(self, upstream: SUpstream, encoder: CategoryEncoder, config: dict):
        downstream = SuperbXvector(upstream.hidden_sizes[-1], **config.get("build_downstream", {}))
        module = UpstreamDownstreamModel(downstream, upstream.num_layers,
                                         **config.get("build_featurizer", {}))
        # margin/scale mirror the reference's amsoftmax loss params
        # (nn/speaker_loss.py amsoftmax: margin 0.4, scale 30)
        return SpeakerVerificationTask(module, num_speakers=len(encoder),
                                       **config.get("build_task", {}))

    def build_dataset(self, csv_path, encoder):
        return SpeakerDataset(csv_path, encoder)

    def _eval_trainer(self, workspace: Path, config: dict):
        """The trainer with the newest step's probe (the JAX recipes' stage 3
        loads ``latest_checkpoint``, not ``valid_best``)."""
        trainer, encoder = self._trainer(workspace, config)
        trainer.init(resume=False)
        load_dir = ckpt.latest_checkpoint(workspace / "train")
        if load_dir is not None:
            trainer.task.module.load_state_dict(ckpt.load_checkpoint(load_dir, trainer.device)[0])
        return trainer, encoder

    def _score(self, workspace: Path, emb_by_name: dict):
        """The trial list's EER / minDCF into result.yaml."""
        trials_df = pd.read_csv(workspace / "trials.csv")
        # trial names use 'spk/session/utt.wav' paths; test.csv ids replace '/'
        trials = [
            (int(r["label"]), r["enroll"].replace("/", "-"), r["test"].replace("/", "-"))
            for _, r in trials_df.iterrows()
        ]
        logs = SpeakerVerificationTask.score_trials(emb_by_name, trials)
        with open(workspace / "result.yaml", "w") as f:
            yaml.safe_dump({"test": logs}, f)
        return {"test": logs}

    def evaluate_stage(self, workspace: Path, config: dict):
        """Embed the test utterances; score the trial list."""
        trainer, encoder = self._eval_trainer(workspace, config)
        loader = self._loader(workspace, "test.csv", encoder, "test", config)
        emb_by_name = {}
        for batch in loader:
            device, host = _split_batch(batch)
            hs, h_lens = trainer.forward_upstream(device)
            emb = trainer.task.embed(hs, h_lens).cpu().numpy()
            for i, name in enumerate(host["unique_name"]):
                emb_by_name[name] = emb[i]
        return self._score(workspace, emb_by_name)


class AsvExample(SuperbASV):
    """Smoke-test ASV on pseudo speakers (integration-test artifact)."""

    def default_config(self) -> dict:
        cfg = super().default_config()
        cfg["prepare_data"] = {"num_speakers": 3, "utts_per_speaker": 4}
        cfg["build_downstream"] = {"output_size": 32, "hidden_size": 32, "aggregation_size": 64}
        cfg["build_batch_sampler"] = {"batch_size": 4}
        cfg["train"] = {"total_steps": 4, "log_step": 2, "eval_step": 10**9, "save_step": 2}
        return cfg

    def prepare_data(self, workspace: Path, config: dict):
        from ..util.pseudo_data import _write_wav

        cfg = config.get("prepare_data", {})
        rng = np.random.RandomState(0)
        wav_dir = workspace / "wavs"
        wav_dir.mkdir(parents=True, exist_ok=True)
        rows_train, rows_test = [], []
        n_spk = cfg.get("num_speakers", 3)
        n_utt = cfg.get("utts_per_speaker", 4)
        for s in range(n_spk):
            for u in range(n_utt):
                wav = (rng.randn(int(16000 * rng.uniform(0.5, 1.5))) * 0.1).astype(np.float32)
                path = wav_dir / f"spk{s}_utt{u}.wav"
                _write_wav(path, wav)
                row = dict(id=f"spk{s}-utt{u}", wav_path=str(path), label=f"spk{s}")
                (rows_test if u >= n_utt - 2 else rows_train).append(row)
        pd.DataFrame(rows_train).to_csv(workspace / "train.csv", index=False)
        pd.DataFrame(rows_test).to_csv(workspace / "test.csv", index=False)
        trials = []
        test_ids = [r["id"].replace("-", "/") for r in rows_test]
        for i, a in enumerate(test_ids):
            for b in test_ids[i + 1:]:
                label = int(a.split("/")[0] == b.split("/")[0])
                trials.append((label, a, b))
        pd.DataFrame(trials, columns=["label", "enroll", "test"]).to_csv(
            workspace / "trials.csv", index=False
        )


class _RandomCropDataset:
    """Random fixed-length training crop (reference: voxceleb2_ge2e/
    dataset.py:57 max_timestep)."""

    def __init__(self, base, max_timestep: int, seed: int = 0):
        self.base = base
        self.max_timestep = max_timestep
        self.rng = np.random.RandomState(seed)

    def __len__(self):
        return len(self.base)

    def __getattr__(self, name):
        return getattr(self.base, name)

    def __getitem__(self, i):
        item = self.base[i]
        x = item["x"]
        if len(x) > self.max_timestep:
            start = self.rng.randint(0, len(x) - self.max_timestep + 1)
            item["x"] = x[start:start + self.max_timestep]
        return item


class Voxceleb2GE2E(SuperbASV):
    """GE2E speaker verification (legacy downstream/voxceleb2_ge2e):
    AdamW 4e-4, 100k steps, batches of 10 speakers x 10 utterances (each
    cropped to 5 s in training), Identity + SAP embedder, GE2E loss."""

    def default_config(self) -> dict:
        cfg = super().default_config()
        cfg["build_downstream"] = {"input_dim": 256}
        cfg["build_batch_sampler"] = {
            "speakers_per_batch": 10, "utts_per_speaker": 10,
        }
        cfg["build_task"] = {}
        cfg["build_optimizer"] = {"name": "AdamW", "lr": 4.0e-4}
        cfg["max_timestep"] = 16000 * 5  # train-time random crop (dataset.py:57)
        cfg["train"] = {
            "total_steps": 100000, "log_step": 500, "eval_step": 10**9,
            "save_step": 10000, "gradient_clipping": 1000.0,
        }
        return cfg

    def build_task(self, upstream: SUpstream, encoder: CategoryEncoder, config: dict):
        head = SapSpeakerHead(upstream.hidden_sizes[-1], **config.get("build_downstream", {}))
        module = UpstreamDownstreamModel(head, upstream.num_layers,
                                         **config.get("build_featurizer", {}))
        utts = config.get("build_batch_sampler", {}).get("utts_per_speaker", 10)
        return Ge2eVerificationTask(module, utts_per_speaker=utts)

    def build_dataset(self, csv_path, encoder):
        ds = SpeakerDataset(csv_path, encoder)
        max_t = getattr(self, "_max_timestep", None)
        return _RandomCropDataset(ds, max_t) if max_t else ds

    def build_batch_sampler(self, dataset, mode: str, config: dict):
        if mode in ("train", "valid"):
            labels = [dataset.df.iloc[i]["label"] for i in range(len(dataset))]
            cfg = config.get("build_batch_sampler", {})
            return GE2EBatchSampler(
                labels,
                speakers_per_batch=cfg.get("speakers_per_batch", 10),
                utts_per_speaker=cfg.get("utts_per_speaker", 10),
            )
        return FixedBatchSizeBatchSampler(len(dataset), 8, shuffle=False)

    def _loader(self, workspace, csv_name, encoder, mode, config):
        self._max_timestep = config.get("max_timestep") if mode == "train" else None
        return super()._loader(workspace, csv_name, encoder, mode, config)


class Ge2eExample(Voxceleb2GE2E):
    """Smoke-test GE2E on pseudo speakers."""

    def default_config(self) -> dict:
        cfg = super().default_config()
        cfg["prepare_data"] = {"num_speakers": 3, "utts_per_speaker": 4}
        cfg["build_batch_sampler"] = {"speakers_per_batch": 2, "utts_per_speaker": 2}
        cfg["train"] = {"total_steps": 4, "log_step": 2, "eval_step": 10**9, "save_step": 2}
        return cfg

    prepare_data = AsvExample.prepare_data


class Voxceleb2AMSoftmaxSegment(SuperbASV):
    """AM-softmax speaker verification with SEGMENT evaluation (legacy
    downstream/voxceleb2_amsoftmax_segment_eval): Adam 5e-4, 100k steps,
    accum 5, batch 10, x-vector with self-attentive pooling (agg SAP,
    agg_dim 1500); test utterances unfold into 8 s windows with 4 s stride
    (segment_config window 128000 / stride 64000), per-utterance embedding =
    mean of unit-normalized segment embeddings: one upstream forward an
    utterance."""

    SEG_WINDOW = 128000
    SEG_STRIDE = 64000

    def default_config(self) -> dict:
        cfg = super().default_config()
        cfg["build_downstream"] = {"output_size": 512, "hidden_size": 512,
                                   "aggregation_size": 1500,
                                   "pooling": "SelfAttentivePooling"}
        cfg["build_optimizer"] = {"name": "Adam", "lr": 5.0e-4}
        cfg["train"]["total_steps"] = 100000
        return cfg

    def evaluate_stage(self, workspace: Path, config: dict):
        """Segment-unfold embedding extraction + trial cosine scoring."""
        trainer, encoder = self._eval_trainer(workspace, config)
        ds = SpeakerDataset(workspace / "test.csv", encoder)
        emb_by_name = {}
        for i in range(len(ds)):
            item = ds[i]
            wav = item["x"]
            starts = list(range(0, max(len(wav) - self.SEG_WINDOW, 0) + 1,
                                self.SEG_STRIDE)) or [0]
            segs = np.zeros((len(starts), min(self.SEG_WINDOW, len(wav))),
                            np.float32)
            for j, s in enumerate(starts):
                chunk = wav[s:s + self.SEG_WINDOW]
                segs[j, :len(chunk)] = chunk
            lens = np.asarray([min(len(wav) - s, self.SEG_WINDOW)
                               for s in starts], np.int32)
            hs, h_lens = trainer.upstream(segs, lens)
            emb = trainer.task.embed(hs, h_lens).cpu().numpy()
            emb = emb / np.maximum(np.linalg.norm(emb, axis=-1, keepdims=True), 1e-8)
            emb_by_name[item["unique_name"]] = emb.mean(axis=0)
        return self._score(workspace, emb_by_name)


class AmsoftmaxSegmentExample(Voxceleb2AMSoftmaxSegment):
    """Smoke-test the segment-eval ASV variant on pseudo speakers."""

    SEG_WINDOW = 8000
    SEG_STRIDE = 4000

    def default_config(self) -> dict:
        cfg = super().default_config()
        cfg["prepare_data"] = {"num_speakers": 3, "utts_per_speaker": 4}
        cfg["build_downstream"] = {"output_size": 32, "hidden_size": 32,
                                   "aggregation_size": 64,
                                   "pooling": "SelfAttentivePooling"}
        cfg["build_batch_sampler"] = {"batch_size": 4}
        cfg["train"] = {"total_steps": 4, "log_step": 2, "eval_step": 10**9,
                        "save_step": 2}
        return cfg

    prepare_data = AsvExample.prepare_data
