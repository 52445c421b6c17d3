"""Speech translation problem, SUPERB-SG ST (port of
s3prl_tpu/problem/translation.py).

Behavioral spec from the reference (s3prl/downstream/speech_translation:
CoVoST2 en->de with a fairseq S2T transformer and sacrebleu): stage 0 CSVs
with the ``translation`` text, stage 1 the subword tokenizer (first-party
BPE, `data/bpe.py`), stage 2 encoder-decoder training over the frozen
upstream's features, stage 3 greedy decoding and corpus BLEU. The recipes'
default upstream is ``fbank``.
"""

from __future__ import annotations

import logging
from pathlib import Path

import numpy as np
import pandas as pd
import yaml

from .base import Problem
from ..data.bpe import SubwordTokenizer
from ..data.collate import Buckets, pad_collate
from ..data.dataset import Speech2TextDataset
from ..data.encoder import load_tokenizer
from ..data.loader import DataLoader
from ..data.sampler import FixedBatchSizeBatchSampler, SortedBucketingSampler
from ..models.decoder import DecoderConfig, TransformerDecoder
from ..nn.heads import FrameLevelLinear
from ..nn.upstream import SUpstream, UpstreamDownstreamModel
from ..task.speech_translation import SpeechTranslationTask
from ..train import checkpoint as ckpt
from ..train.trainer import Trainer, TrainerConfig, _split_batch

logger = logging.getLogger(__name__)


class SuperbST(Problem):
    STAGES = ["prepare_data", "build_encoder", "train_stage", "evaluate_stage"]

    def default_config(self) -> dict:
        return {
            "target_dir": "???",
            "prepare_data": {"covost_tsv": "???", "audio_root": "???"},
            "build_upstream": {"name": "fbank"},
            "build_encoder": {"vocab_size": 8000},
            "build_downstream": {"hidden_size": 256, "num_layers": 3, "num_heads": 4, "ffn_size": 1024},
            "build_batch_sampler": {"batch_size": 16},
            # Adam lr 1e-3, 32k steps, accumulation 8 (speech_translation/
            # config.yaml: optimizer lr 0.001, runner total_steps 32000 /
            # gradient_accumulate_steps 8; label-smoothed CE 0.1 is the task's
            # default)
            "build_optimizer": {"name": "Adam", "lr": 1.0e-3, "scheduler": "linear_schedule"},
            "train": {"total_steps": 32000, "log_step": 500, "eval_step": 5000,
                      "save_step": 1000, "gradient_accumulate": 8},
        }

    def prepare_data(self, workspace: Path, config: dict):
        """CoVoST2 tsv: path / sentence / translation columns."""
        cfg = config["prepare_data"]
        root = Path(cfg["audio_root"])
        for split in ["train", "dev", "test"]:
            tsv = Path(cfg["covost_tsv"]) / f"covost_v2.en_de.{split}.tsv"
            if not tsv.exists():
                continue
            df = pd.read_csv(tsv, sep="\t")
            out = pd.DataFrame(
                dict(
                    id=df["path"].str.replace("/", "-", regex=False),
                    wav_path=[str(root / p) for p in df["path"]],
                    transcription=df["translation"],
                )
            )
            name = {"dev": "valid"}.get(split, split)
            out.to_csv(workspace / f"{name}.csv", index=False)

    def build_encoder(self, workspace: Path, config: dict):
        df = pd.read_csv(workspace / "train.csv")
        tok = SubwordTokenizer.from_text(
            df["transcription"].astype(str),
            vocab_size=config.get("build_encoder", {}).get("vocab_size", 8000),
        )
        tok.save(workspace / "tokenizer.json")
        return tok

    def build_upstream(self, name: str = "fbank", **kwargs) -> SUpstream:
        return SUpstream(name, **kwargs)

    def build_task(self, upstream: SUpstream, tokenizer, config: dict) -> SpeechTranslationTask:
        """FrameLevelLinear(hidden) over the featurized states, then the
        decoder of ``build_downstream``'s shape over the tokenizer's vocab."""
        d_cfg = config.get("build_downstream", {})
        hidden = d_cfg.get("hidden_size", 256)
        encoder_module = UpstreamDownstreamModel(
            downstream=FrameLevelLinear(upstream.hidden_sizes[-1], hidden),
            num_layers=upstream.num_layers,
            **config.get("build_featurizer", {}),
        )
        decoder = TransformerDecoder(DecoderConfig(
            vocab_size=tokenizer.vocab_size,
            hidden_size=hidden,
            num_layers=d_cfg.get("num_layers", 3),
            num_heads=d_cfg.get("num_heads", 4),
            ffn_size=d_cfg.get("ffn_size", 1024),
        ))
        return SpeechTranslationTask(encoder_module, decoder, tokenizer)

    def _build(self, workspace, config):
        tokenizer = load_tokenizer(workspace / "tokenizer.json")
        upstream = self.build_upstream(**config.get("build_upstream", {}))
        task = self.build_task(upstream, tokenizer, config)
        trainer = Trainer(
            upstream.upstream, task, workspace / "train",
            TrainerConfig(optimizer=config.get("build_optimizer", {"name": "Adam", "lr": 1e-4}),
                          **config.get("train", {})),
        )
        return tokenizer, trainer

    def _loader(self, workspace, csv_name, tokenizer, mode, config):
        csv_path = workspace / csv_name
        if not csv_path.exists():
            return None
        ds = Speech2TextDataset(csv_path, tokenizer)
        cfg = config.get("build_batch_sampler", {})
        if mode == "train":
            sampler = SortedBucketingSampler(ds.lengths, cfg.get("batch_size", 16), shuffle=True)
        else:
            sampler = FixedBatchSizeBatchSampler(len(ds), cfg.get("batch_size", 16))
        buckets = Buckets.linear(config.get("bucket_step", 16000), 16000 * 30)
        return DataLoader(ds, sampler, lambda items: pad_collate(items, buckets),
                          distribute=mode == "train")

    def train_stage(self, workspace: Path, config: dict):
        tokenizer, trainer = self._build(workspace, config)
        trainer.train(
            self._loader(workspace, "train.csv", tokenizer, "train", config),
            self._loader(workspace, "valid.csv", tokenizer, "valid", config),
        )
        return trainer

    def evaluate_stage(self, workspace: Path, config: dict):
        from ..metric.bleu import corpus_bleu

        tokenizer, trainer = self._build(workspace, config)
        loader = self._loader(workspace, "test.csv", tokenizer, "test", config)
        trainer.init(resume=False)
        best = workspace / "train" / "valid_best"
        load_dir = best if best.exists() else ckpt.latest_checkpoint(workspace / "train")
        if load_dir is not None:
            trainer.task.module.load_state_dict(ckpt.load_checkpoint(load_dir, trainer.device)[0])
        hyps, refs = [], []
        for batch in loader:
            device, host = _split_batch(batch)
            hs, h_lens = trainer.forward_upstream(device)
            decoded = trainer.task.greedy_decode(hs, h_lens)
            for b in range(len(decoded)):
                hyps.append(tokenizer.decode(decoded[b].tolist()))
            refs.extend(host["labels"])
        logs = {"bleu": corpus_bleu(hyps, refs)}
        with open(workspace / "result.yaml", "w") as f:
            yaml.safe_dump({"test": logs}, f)
        return {"test": logs}


class StExample(SuperbST):
    """Smoke test: pseudo audio with toy 'translations'."""

    def default_config(self) -> dict:
        cfg = super().default_config()
        cfg["prepare_data"] = {"num": 6}
        cfg["build_encoder"] = {"vocab_size": 60}
        cfg["build_downstream"] = {"hidden_size": 32, "num_layers": 1, "num_heads": 2, "ffn_size": 64}
        cfg["build_batch_sampler"] = {"batch_size": 2}
        cfg["train"] = {"total_steps": 4, "log_step": 2, "eval_step": 2, "save_step": 2}
        return cfg

    def prepare_data(self, workspace: Path, config: dict):
        from ..util.pseudo_data import _write_wav

        rng = np.random.RandomState(0)
        (workspace / "wavs").mkdir(parents=True, exist_ok=True)
        texts = ["guten tag", "hallo welt", "wie geht es"]
        for split, n in [("train", config["prepare_data"].get("num", 6)), ("valid", 2), ("test", 2)]:
            rows = []
            for i in range(n):
                wav = (rng.randn(int(16000 * rng.uniform(0.4, 0.8))) * 0.1).astype(np.float32)
                p = workspace / "wavs" / f"{split}_{i}.wav"
                _write_wav(p, wav)
                rows.append(dict(id=f"{split}_{i}", wav_path=str(p),
                                 transcription=texts[i % len(texts)]))
            pd.DataFrame(rows).to_csv(workspace / f"{split}.csv", index=False)
