"""IEMOCAP parser (SUPERB ER) (a copy of s3prl_tpu/data/corpus/iemocap.py).

Behavioral spec from the reference's parser (s3prl/dataio/corpus/iemocap.py
+ problem/common/superb_er.py): four classes (neu, hap+exc merged, ang, sad),
5-fold cross validation by session — `test_fold` session is the test set,
the previous session is validation, the rest train.
"""

from __future__ import annotations

import re
from pathlib import Path

import pandas as pd

EMOTION_MAP = {"neu": "neu", "hap": "hap", "exc": "hap", "ang": "ang", "sad": "sad"}


def _parse_session(session_dir: Path):
    rows = []
    emo_dir = session_dir / "dialog" / "EmoEvaluation"
    wav_root = session_dir / "sentences" / "wav"
    for txt in sorted(emo_dir.glob("*.txt")):
        for line in txt.read_text().splitlines():
            m = re.match(r"\[.*\]\s+(\S+)\s+(\S+)\s+\[.*\]", line)
            if not m:
                continue
            utt, emo = m.group(1), m.group(2)
            if emo not in EMOTION_MAP:
                continue
            wav = wav_root / utt.rsplit("_", 1)[0] / f"{utt}.wav"
            rows.append(dict(id=utt, wav_path=str(wav), label=EMOTION_MAP[emo]))
    return rows


def prepare_iemocap(workspace, iemocap: str, test_fold: int = 1):
    root = Path(iemocap)
    sessions = {i: _parse_session(root / f"Session{i}") for i in range(1, 6)}
    valid_fold = test_fold - 1 if test_fold > 1 else 5
    train, valid, test = [], [], []
    for i, rows in sessions.items():
        (test if i == test_fold else valid if i == valid_fold else train).extend(rows)
    workspace = Path(workspace)
    pd.DataFrame(train).to_csv(workspace / "train.csv", index=False)
    pd.DataFrame(valid).to_csv(workspace / "valid.csv", index=False)
    pd.DataFrame(test).to_csv(workspace / "test.csv", index=False)
