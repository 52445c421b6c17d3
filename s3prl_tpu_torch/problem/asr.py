"""CTC ASR / phoneme recognition / slot filling problems, SUPERB ASR / PR /
SF (port of s3prl_tpu/problem/asr.py).

Behavioral spec from the reference's ASR run procedure
(s3prl/problem/asr/run.py:23 + superb_asr.py:184-252, superb_pr.py:74-97,
superb_sf.py): stage 0 prepare_data (LibriSpeech train-clean-100 -> CSVs
with transcriptions; Audio SNIPS for SF), stage 1 tokenizer (characters for
ASR; phonemes for PR; characters and slot tags for SF), stage 2
frozen-upstream BLSTM-CTC training (on the card: the upstream's kernels,
cuDNN's LSTM, the CTC loss), stage 3 WER / PER / slot F1 evaluation, and
single-file transcription (`CommonProblem.inference`, greedy CTC).

As in the JAX package, `SuperbPR`'s `PhonemeTokenizer` splits the
transcripts on spaces: there is no G2P step, so on LibriSpeech's word
transcripts its "phonemes" are words. The recipes' default upstream
(``fbank``) is not ported: a run names a trunk entry in ``build_upstream``.
"""

from __future__ import annotations

import logging
from pathlib import Path

import numpy as np
import pandas as pd

from .common import CommonProblem
from ..data.dataset import SlotFillingDataset, Speech2TextDataset
from ..data.encoder import (CharacterSlotTokenizer, CharacterTokenizer, PhonemeTokenizer,
                            load_tokenizer)
from ..data.sampler import FixedBatchSizeBatchSampler, SortedBucketingSampler
from ..nn.heads import RNNEncoder
from ..nn.upstream import SUpstream
from ..task.speech2text_ctc import SlotFillingCTCTask, Speech2TextCTCTask

logger = logging.getLogger(__name__)


class SuperbASR(CommonProblem):
    """Character CTC on LibriSpeech-100 (reference: superb_asr.py:184-252)."""

    metric = "wer"

    def default_config(self) -> dict:
        return {
            "target_dir": "???",
            "prepare_data": {"librispeech": "???"},
            "build_upstream": {"name": "fbank"},
            "build_downstream": {
                "hidden_size": 1024,
                "num_layers": 2,
                "proj_size": 1024,
                "dropout": 0.2,
            },
            "build_batch_sampler": {"batch_size": 32, "max_length": 16000 * 20},
            "build_optimizer": {"name": "Adam", "lr": 1.0e-4},
            "train": {
                "total_steps": 200000,
                "log_step": 500,
                "eval_step": 5000,
                "save_step": 1000,
                "gradient_clipping": 1.0,
                "gradient_accumulate": 1,
            },
        }

    def prepare_data(self, workspace: Path, config: dict):
        from ..data.corpus.librispeech import prepare_librispeech_asr

        return prepare_librispeech_asr(workspace, **config.get("prepare_data", {}))

    def build_encoder(self, workspace: Path, config: dict):
        df = pd.read_csv(workspace / "train.csv")
        tokenizer = CharacterTokenizer.from_text(df["transcription"].astype(str))
        tokenizer.save(workspace / "tokenizer.json")
        return tokenizer

    def load_encoder(self, workspace: Path):
        return load_tokenizer(workspace / "tokenizer.json")

    def build_downstream(self, input_size: int, output_size: int, **kwargs):
        return RNNEncoder(input_size, output_size, **kwargs)

    def build_task(self, upstream: SUpstream, tokenizer, config: dict):
        return Speech2TextCTCTask(self._module(upstream, tokenizer.vocab_size, config), tokenizer,
                                  metric=self.metric)

    def build_dataset(self, csv_path, tokenizer):
        return Speech2TextDataset(csv_path, tokenizer)

    def build_batch_sampler(self, dataset, mode: str, config: dict):
        cfg = dict(config.get("build_batch_sampler", {}))
        if mode == "train":
            return SortedBucketingSampler(
                dataset.lengths,
                batch_size=cfg.get("batch_size", 32),
                max_length=cfg.get("max_length", 16000 * 20),
                shuffle=True,
            )
        return FixedBatchSizeBatchSampler(len(dataset), cfg.get("batch_size", 32))

    # single-file inference decode: greedy CTC (unique-consecutive, drop
    # blanks - reference speech2text_ctc_task.py:112-137)
    def _decode_prediction(self, tokenizer, logits) -> str:
        ids = np.argmax(logits[0], axis=-1).tolist()
        return tokenizer.decode(ids, ignore_repeat=True)


class SuperbPR(SuperbASR):
    """Phoneme recognition (reference: superb_pr.py:74-97): phoneme tokenizer
    over the transcripts, Adam lr 1e-2, 100k steps, accum 2."""

    metric = "per"

    def default_config(self) -> dict:
        cfg = super().default_config()
        cfg["build_optimizer"] = {"name": "Adam", "lr": 1.0e-2}
        cfg["train"]["total_steps"] = 100000
        cfg["train"]["gradient_accumulate"] = 2
        cfg["build_downstream"] = {"hidden_size": 256, "num_layers": 1, "proj_size": 256}
        # batch 16 (superb_pr.py:48; legacy ctc/libriphone.yaml corpus.batch_size)
        cfg["build_batch_sampler"]["batch_size"] = 16
        return cfg

    def build_encoder(self, workspace: Path, config: dict):
        df = pd.read_csv(workspace / "train.csv")
        tokenizer = PhonemeTokenizer.from_text(
            df["transcription"].astype(str), vocab_size=100000
        )
        tokenizer.save(workspace / "tokenizer.json")
        return tokenizer


class SuperbSF(SuperbASR):
    """Slot filling on Audio SNIPS (reference: problem/asr/superb_sf.py):
    character+slot CTC; slot-type F1 and slot-value CER reduction."""

    metric = "slot_type_f1"

    def default_config(self) -> dict:
        cfg = super().default_config()
        cfg["prepare_data"] = {"snips": "???"}
        return cfg

    def prepare_data(self, workspace: Path, config: dict):
        from ..data.corpus.snips import prepare_snips

        return prepare_snips(workspace, **config.get("prepare_data", {}))

    def build_encoder(self, workspace: Path, config: dict):
        df = pd.read_csv(workspace / "train.csv")
        tokenizer = CharacterSlotTokenizer.from_text(
            df["transcription"].astype(str), df["iob"].astype(str)
        )
        tokenizer.save(workspace / "tokenizer.json")
        return tokenizer

    def build_dataset(self, csv_path, tokenizer):
        return SlotFillingDataset(csv_path, tokenizer)

    def build_task(self, upstream: SUpstream, tokenizer, config: dict):
        return SlotFillingCTCTask(self._module(upstream, tokenizer.vocab_size, config), tokenizer)


class AsrExample(SuperbASR):
    """Smoke-test ASR on pseudo audio with toy transcripts."""

    def default_config(self) -> dict:
        cfg = super().default_config()
        cfg["prepare_data"] = {"num_train": 6, "num_valid": 2, "num_test": 2}
        cfg["build_downstream"] = {"hidden_size": 32, "num_layers": 1, "proj_size": 32}
        cfg["build_batch_sampler"] = {"batch_size": 2}
        cfg["train"] = {"total_steps": 4, "log_step": 2, "eval_step": 2, "save_step": 2}
        return cfg

    def prepare_data(self, workspace: Path, config: dict):
        from ..util.pseudo_data import _write_wav

        cfg = config.get("prepare_data", {})
        rng = np.random.RandomState(0)
        wav_dir = workspace / "wavs"
        wav_dir.mkdir(parents=True, exist_ok=True)
        texts = ["hello world", "good day", "speech test", "jax on tpu"]
        for split, n in [
            ("train", cfg.get("num_train", 6)),
            ("valid", cfg.get("num_valid", 2)),
            ("test", cfg.get("num_test", 2)),
        ]:
            rows = []
            for i in range(n):
                secs = float(rng.uniform(0.5, 1.5))
                wav = (rng.randn(int(16000 * secs)) * 0.1).astype(np.float32)
                path = wav_dir / f"{split}_{i}.wav"
                _write_wav(path, wav)
                rows.append(dict(id=f"{split}_{i}", wav_path=str(path),
                                 transcription=texts[i % len(texts)], duration=secs))
            pd.DataFrame(rows).to_csv(workspace / f"{split}.csv", index=False)
