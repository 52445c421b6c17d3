"""Spoken language understanding recipes: ATIS, SNIPS audio SLU and CMU-MOSEI
(port of s3prl_tpu/problem/slu.py:34-214; the legacy downstream experts
atis, audio_snips and mosei).

- SluATIS (atis/expert.py:31-70, model.py:105-130): intents from the
  ``nlu_iob`` TSVs (the annotation's last token), the head a projector, a
  2-layer post-LN Mockingjay encoder (512 wide, 8 heads, FFN 2,048, erf
  GELU, dropout 0.1 in train), self-attentive pooling and a linear layer;
  AdamW 2e-4, 20k steps, batch 1, accumulation 48.
- SluAudioSnips (audio_snips/expert.py:35-63): the same head over the SNIPS
  audio SLU corpus (``data/nlu_annotation`` TSVs, speaker-prefixed wavs);
  200k steps.
- MoseiSentiment (mosei/model.py:5-13, expert.py:55-91): CMU-MOSEI's
  sentiment score binned to 2, 3 or 7 classes under CommonProblem's
  UtteranceLevel(256, MeanPooling); AdamW 2e-4, batch 3, accumulation 5.
- SluExample: tone-class "intents" through the transformer head.

The recipes' default upstream is ``fbank``; a run may name any entry in
``build_upstream``.
"""

from __future__ import annotations

from pathlib import Path
from typing import Optional

import numpy as np
import pandas as pd
import torch
import torch.nn as nn

from .common import CommonProblem
from ..models.mockingjay import MockingjayConfig, MockingjayEncoder
from ..nn.heads import Dense, SelfAttentivePooling


class SluTransformerHead(nn.Module):
    """``projector`` -> ``encoder`` (a MockingjayEncoder with atis/
    config.yaml's hparams) -> ``sap`` over its last layer in f32 ->
    ``final``: (xs [B, T, input_size], xs_len [B]) -> logits [B, C]. The
    encoder's dropout draws from the caller's generator in train()."""

    def __init__(self, input_size: int, output_size: int, input_dim: int = 512,
                 num_layers: int = 2, num_heads: int = 8, ffn_size: int = 2048):
        super().__init__()
        self.projector = Dense(input_size, input_dim)
        self.encoder = MockingjayEncoder(MockingjayConfig(
            input_dim=input_dim, hidden_size=input_dim, num_hidden_layers=num_layers,
            num_attention_heads=num_heads, intermediate_size=ffn_size))
        self.sap = SelfAttentivePooling(input_dim)
        self.final = Dense(input_dim, output_size)

    def forward(self, xs: torch.Tensor, xs_len: torch.Tensor,
                generator: Optional[torch.Generator] = None) -> torch.Tensor:
        hs, _ = self.encoder(self.projector(xs), xs_len, generator)
        return self.final(self.sap(hs[-1].float(), xs_len))


class SluATIS(CommonProblem):
    """ATIS intent classification from audio (legacy downstream/atis)."""

    def default_config(self) -> dict:
        return {
            "target_dir": "???",
            "prepare_data": {"atis": "???"},
            "build_upstream": {"name": "fbank"},
            "build_downstream": {"input_dim": 512, "num_layers": 2,
                                 "num_heads": 8, "ffn_size": 2048},
            "build_batch_sampler": {"batch_size": 1},
            "build_optimizer": {"name": "AdamW", "lr": 2.0e-4},
            "train": {
                "total_steps": 20000, "log_step": 500, "eval_step": 2000,
                "save_step": 1000, "gradient_accumulate": 48,
            },
        }

    def prepare_data(self, workspace: Path, config: dict):
        """ATIS layout (atis/expert.py:41-55): nlu_iob/iob.{train,dev,test}
        TSVs, column 0 'id text', column 1 'BOS-annotation ... intent'; wavs
        under <root>/<id>.wav."""
        root = Path(config["prepare_data"]["atis"])
        for split, name in [("train", "train"), ("valid", "dev"), ("test", "test")]:
            tsv = root / "nlu_iob" / f"iob.{name}"
            if not tsv.exists():
                continue
            df = pd.read_csv(tsv, sep="\t", header=None)
            rows = []
            for i in range(len(df)):
                utt_id = str(df[0][i]).split()[0]
                intent = str(df[1][i]).split()[-1]
                rows.append(dict(id=f"{split}_{i}", wav_path=str(root / f"{utt_id}.wav"),
                                 label=intent))
            pd.DataFrame(rows).to_csv(workspace / f"{split}.csv", index=False)

    def build_downstream(self, input_size: int, output_size: int, **kwargs):
        return SluTransformerHead(input_size, output_size, **kwargs)


class SluAudioSnips(SluATIS):
    """SNIPS audio SLU intent classification (legacy downstream/audio_snips)."""

    def default_config(self) -> dict:
        cfg = super().default_config()
        cfg["prepare_data"] = {"audio_slu": "???",
                               "train_speakers": None, "test_speakers": None}
        cfg["train"]["total_steps"] = 200000
        return cfg

    def prepare_data(self, workspace: Path, config: dict):
        """SNIPS SLU layout (audio_snips/expert.py:35-63): data/nlu_annotation
        {train,valid,test} TSVs with 'id' and 'annotation' columns; wavs per
        speaker under <root>/<speaker>-<id>.wav."""
        cfg = config["prepare_data"]
        root = Path(cfg["audio_slu"])
        for split in ("train", "valid", "test"):
            tsv = root / "data" / "nlu_annotation" / split
            if not tsv.exists():
                continue
            df = pd.read_csv(tsv, sep="\t")
            spk_key = "train_speakers" if split != "test" else "test_speakers"
            speakers = cfg.get(spk_key) or [""]
            rows = []
            for spk in speakers:
                for i in range(len(df)):
                    utt_id = str(df["id"][i]) if "id" in df.columns else str(df.iloc[i, 0])
                    intent = str(df["annotation"].iloc[i]).split()[-1] \
                        if "annotation" in df.columns else str(df.iloc[i, -1]).split()[-1]
                    prefix = f"{spk}-" if spk else ""
                    rows.append(dict(id=f"{split}_{spk}_{i}",
                                     wav_path=str(root / f"{prefix}{utt_id}.wav"),
                                     label=intent))
            pd.DataFrame(rows).to_csv(workspace / f"{split}.csv", index=False)


class MoseiSentiment(CommonProblem):
    """CMU-MOSEI sentiment classification (legacy downstream/mosei)."""

    def default_config(self) -> dict:
        return {
            "target_dir": "???",
            "prepare_data": {"mosei_audio": "???", "label_csv": "???",
                             "num_class": 2},
            "build_upstream": {"name": "fbank"},
            "build_downstream": {"hidden_size": 256, "pooling": "MeanPooling"},
            "build_batch_sampler": {"batch_size": 3},
            "build_optimizer": {"name": "AdamW", "lr": 2.0e-4},
            "train": {
                "total_steps": 20000, "log_step": 500, "eval_step": 2000,
                "save_step": 1000, "gradient_accumulate": 5,
            },
        }

    @staticmethod
    def _bin_sentiment(score: float, num_class: int) -> str:
        """mosei/expert.py:60-74: the sentiment score's class."""
        if num_class == 2:
            return "pos" if score > 0 else "neg"
        if num_class == 3:
            return "pos" if score > 0 else ("neg" if score < 0 else "neu")
        # 6 / 7 classes: rounded onto the -3..3 scale
        return str(int(np.clip(round(score), -3, 3)))

    def prepare_data(self, workspace: Path, config: dict):
        cfg = config["prepare_data"]
        root = Path(cfg["mosei_audio"])
        df = pd.read_csv(cfg["label_csv"], encoding="latin-1")
        n_class = cfg.get("num_class", 2)
        for split in ("train", "valid", "test"):
            sub = df[df["split"] == split] if "split" in df.columns else df
            rows = []
            for i, r in sub.iterrows():
                rows.append(dict(
                    id=f"{split}_{i}",
                    wav_path=str(root / f"{r['file']}.wav"),
                    label=self._bin_sentiment(float(r["sentiment"]), n_class),
                ))
            pd.DataFrame(rows).to_csv(workspace / f"{split}.csv", index=False)


class SluExample(SluATIS):
    """Smoke test: tone-class "intents" through the transformer + SAP head."""

    def default_config(self) -> dict:
        cfg = super().default_config()
        cfg["prepare_data"] = {"num": 8}
        cfg["build_downstream"] = {"input_dim": 64, "num_layers": 1,
                                   "num_heads": 4, "ffn_size": 128}
        cfg["build_batch_sampler"] = {"batch_size": 2}
        cfg["train"] = {"total_steps": 4, "log_step": 2, "eval_step": 2,
                        "save_step": 2, "gradient_accumulate": 2}
        return cfg

    def prepare_data(self, workspace: Path, config: dict):
        from ..util.pseudo_data import _write_wav

        rng = np.random.RandomState(0)
        (workspace / "wavs").mkdir(parents=True, exist_ok=True)
        for split, n in [("train", config["prepare_data"].get("num", 8)),
                         ("valid", 3), ("test", 3)]:
            rows = []
            for i in range(n):
                cls = i % 3
                T = int(16000 * rng.uniform(0.5, 1.0))
                wav = (np.sin(2 * np.pi * (300 + 200 * cls) * np.arange(T) / 16000) * 0.3
                       + rng.randn(T) * 0.05).astype(np.float32)
                p = workspace / "wavs" / f"{split}_{i}.wav"
                _write_wav(p, wav)
                rows.append(dict(id=f"{split}_{i}", wav_path=str(p),
                                 label=f"intent{cls}"))
            pd.DataFrame(rows).to_csv(workspace / f"{split}.csv", index=False)
