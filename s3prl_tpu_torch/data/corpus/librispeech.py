"""LibriSpeech corpus parser (a copy of s3prl_tpu/data/corpus/librispeech.py).

Behavioral spec from the reference's parser (s3prl/dataio/corpus/
librispeech.py:88): walk split dirs (train-clean-100, dev-clean, test-clean
...), read the per-chapter `*.trans.txt` transcription files, emit one row
per utterance. Audio is 16 kHz wav or flac (LibriSpeech ships flac, which
data/flac.py decodes).
"""

from __future__ import annotations

import logging
from pathlib import Path
from typing import Dict, List

import pandas as pd

logger = logging.getLogger(__name__)

AUDIO_EXTS = (".wav", ".flac")


def parse_split(root: Path, split: str) -> pd.DataFrame:
    split_dir = Path(root) / split
    if not split_dir.is_dir():
        raise FileNotFoundError(split_dir)
    rows: List[Dict] = []
    for trans in sorted(split_dir.glob("*/*/*.trans.txt")):
        texts = {}
        for line in trans.read_text().splitlines():
            utt_id, _, text = line.partition(" ")
            texts[utt_id] = text.strip()
        for utt_id, text in texts.items():
            base = trans.parent / utt_id
            for ext in AUDIO_EXTS:
                if base.with_suffix(ext).exists():
                    spk = utt_id.split("-")[0]
                    rows.append(
                        dict(id=utt_id, wav_path=str(base.with_suffix(ext)),
                             transcription=text, spk_id=spk)
                    )
                    break
    return pd.DataFrame(rows)


def prepare_librispeech_asr(
    workspace,
    librispeech: str,
    train_split: str = "train-clean-100",
    valid_split: str = "dev-clean",
    test_splits: tuple = ("test-clean",),
):
    """Write train/valid/test CSVs for the SUPERB ASR protocol
    (reference: downstream/asr/config.yaml + problem/asr/superb_asr.py)."""
    workspace = Path(workspace)
    parse_split(Path(librispeech), train_split).to_csv(workspace / "train.csv", index=False)
    parse_split(Path(librispeech), valid_split).to_csv(workspace / "valid.csv", index=False)
    for i, split in enumerate(test_splits):
        name = "test.csv" if len(test_splits) == 1 else f"test_{split}.csv"
        parse_split(Path(librispeech), split).to_csv(workspace / name, index=False)


def parse_librilight(root, subsets=("small",)) -> pd.DataFrame:
    """Libri-Light unlabeled audio lists (reference: dataio/corpus/
    librilight.py): walk <root>/<subset>/<speaker>/<book>/*.flac|wav."""
    rows = []
    for subset in subsets:
        for audio in sorted((Path(root) / subset).rglob("*")):
            if audio.suffix not in AUDIO_EXTS:
                continue
            rows.append(
                dict(id=audio.stem, wav_path=str(audio), spk_id=audio.parts[-3])
            )
    return pd.DataFrame(rows)


def prepare_librilight(workspace, librilight: str, subsets=("small",), valid_fraction=0.01):
    df = parse_librilight(librilight, subsets)
    n_valid = max(int(len(df) * valid_fraction), 1)
    df.iloc[n_valid:].to_csv(Path(workspace) / "train.csv", index=False)
    df.iloc[:n_valid].to_csv(Path(workspace) / "valid.csv", index=False)
