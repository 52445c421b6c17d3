"""Fluent Speech Commands parser (SUPERB IC) (a copy of s3prl_tpu/data/corpus/fluent_commands.py).

Behavioral spec from the reference's parser (s3prl/dataio/corpus/
fluent_speech_commands.py): the shipped data/{train,valid,test}_data.csv
files carry path + action/object/location slots.
"""

from __future__ import annotations

from pathlib import Path

import pandas as pd


def prepare_fluent_commands(workspace, fluent_speech_commands: str):
    root = Path(fluent_speech_commands)
    workspace = Path(workspace)
    for split in ["train", "valid", "test"]:
        df = pd.read_csv(root / "data" / f"{split}_data.csv")
        out = pd.DataFrame(
            dict(
                id=df["path"].str.replace("/", "-", regex=False),
                wav_path=[str(root / p) for p in df["path"]],
                action=df["action"],
                object=df["object"],
                location=df["location"],
            )
        )
        out.to_csv(workspace / f"{split}.csv", index=False)
