"""CSV-driven datasets (a copy of s3prl_tpu/data/dataset.py).

Behavioral spec from the reference's s3prl/dataio/dataset/: map-style
datasets over prepare_data CSVs — LoadAudio (load_audio.py:13: decode +
resample + optional start/end-sec crop), EncodeCategory / EncodeText
(encode.py:18-110). Items are plain dicts of numpy arrays + host strings;
the 'x' key is the waveform, collated into bucketed padded batches.

CSV schema (same as the reference's prepare_data stage): columns
`id`, `wav_path`, and per-task label columns (`label`, `transcription`,
`spk_id`, ...); optional `start_sec` / `end_sec` crops.
"""

from __future__ import annotations

from typing import List

import numpy as np
import pandas as pd

from .audio import load_wav
from .encoder import CategoryEncoder, CategoryEncoders, Tokenizer

SAMPLE_RATE = 16000


class _CsvDataset:
    def __init__(self, csv_path, sample_rate: int = SAMPLE_RATE):
        self.df = pd.read_csv(csv_path)
        self.sample_rate = sample_rate

    def __len__(self) -> int:
        return len(self.df)

    def _load_wav(self, row) -> np.ndarray:
        start = row.get("start_sec", None)
        end = row.get("end_sec", None)
        start = None if start is None or pd.isna(start) else float(start)
        end = None if end is None or pd.isna(end) else float(end)
        wav, _ = load_wav(row["wav_path"], self.sample_rate, start, end)
        return wav.astype(np.float32)

    @property
    def lengths(self) -> List[int]:
        """Sample lengths for length-aware samplers (prefers a duration col)."""
        if "duration" in self.df.columns:
            return (self.df["duration"] * self.sample_rate).astype(int).tolist()
        from .audio import audio_info

        return [audio_info(p)["num_frames"] for p in self.df["wav_path"]]


class UtteranceClassificationDataset(_CsvDataset):
    def __init__(self, csv_path, encoder: CategoryEncoder, sample_rate: int = SAMPLE_RATE):
        super().__init__(csv_path, sample_rate)
        self.encoder = encoder

    def __getitem__(self, i: int) -> dict:
        row = self.df.iloc[i]
        return {
            "x": self._load_wav(row),
            "class_id": int(self.encoder.encode(str(row["label"]))),
            "label": str(row["label"]),
            "unique_name": str(row["id"]),
        }


class UtteranceMultiClassDataset(_CsvDataset):
    """Multiple label columns -> one id per head (SUPERB IC)."""

    def __init__(self, csv_path, encoders: CategoryEncoders, label_columns: List[str], sample_rate: int = SAMPLE_RATE):
        super().__init__(csv_path, sample_rate)
        self.encoders = encoders
        self.label_columns = label_columns

    def __getitem__(self, i: int) -> dict:
        row = self.df.iloc[i]
        labels = [str(row[c]) for c in self.label_columns]
        return {
            "x": self._load_wav(row),
            "class_ids": np.asarray(self.encoders.encode(labels), np.int32),
            "labels": labels,
            "unique_name": str(row["id"]),
        }


class Speech2TextDataset(_CsvDataset):
    def __init__(self, csv_path, tokenizer: Tokenizer, text_column: str = "transcription", sample_rate: int = SAMPLE_RATE):
        super().__init__(csv_path, sample_rate)
        self.tokenizer = tokenizer
        self.text_column = text_column

    def __getitem__(self, i: int) -> dict:
        row = self.df.iloc[i]
        text = str(row[self.text_column])
        ids = np.asarray(self.tokenizer.encode(text), np.int32)
        return {
            "x": self._load_wav(row),
            "class_ids": ids,
            "labels": text,
            "unique_name": str(row["id"]),
        }


class DiarizationChunkDataset(_CsvDataset):
    """Chunked frame-label dataset for SD (reference: dataio/dataset/
    frame_label.py FrameLabelDataset): each row is a fixed window of a
    recording with an .npy [T, num_spk] activity label."""

    def __getitem__(self, i: int) -> dict:
        row = self.df.iloc[i]
        label = np.load(row["label_path"]).astype(np.int32)
        return {
            "x": self._load_wav(row),
            "label": label,
            "unique_name": str(row["id"]),
            "group": str(row["reco"]),
        }


class SlotFillingDataset(_CsvDataset):
    """IOB-tagged transcripts for SF (reference: superb_sf data pipeline)."""

    def __init__(self, csv_path, tokenizer, sample_rate: int = SAMPLE_RATE):
        super().__init__(csv_path, sample_rate)
        self.tokenizer = tokenizer

    def __getitem__(self, i: int) -> dict:
        row = self.df.iloc[i]
        sent, iob = str(row["transcription"]), str(row["iob"])
        ids = np.asarray(self.tokenizer.encode_iob(sent, iob), np.int32)
        # host-side reference text in slot markup for metric computation
        ref = self.tokenizer.decode(ids.tolist())
        return {
            "x": self._load_wav(row),
            "class_ids": ids,
            "labels": ref,
            "unique_name": str(row["id"]),
        }
