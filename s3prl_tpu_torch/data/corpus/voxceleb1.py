"""VoxCeleb1 corpus parser (SID + SV) (a copy of s3prl_tpu/data/corpus/voxceleb1.py).

Behavioral spec from the reference's parser (s3prl/dataio/corpus/
voxceleb1sid.py + downstream/sv_voxceleb1): the official iden_split.txt
assigns utterances to train(1)/valid(2)/test(3) for SID; SV uses the
veri_test trial list over the test split.
"""

from __future__ import annotations

from pathlib import Path
from typing import List, Tuple

import pandas as pd


def prepare_voxceleb1_sid(workspace, voxceleb1: str, iden_split: str = None):
    root = Path(voxceleb1)
    split_file = Path(iden_split) if iden_split else root / "iden_split.txt"
    rows = {1: [], 2: [], 3: []}
    for line in Path(split_file).read_text().splitlines():
        part, rel = line.strip().split()
        spk = rel.split("/")[0]
        path = root / "wav" / rel
        rows[int(part)].append(
            dict(id=rel.replace("/", "-"), wav_path=str(path), label=spk)
        )
    workspace = Path(workspace)
    pd.DataFrame(rows[1]).to_csv(workspace / "train.csv", index=False)
    pd.DataFrame(rows[2]).to_csv(workspace / "valid.csv", index=False)
    pd.DataFrame(rows[3]).to_csv(workspace / "test.csv", index=False)


def parse_trials(trial_file) -> List[Tuple[int, str, str]]:
    """veri_test.txt rows: <label> <path_a> <path_b>."""
    trials = []
    for line in Path(trial_file).read_text().splitlines():
        label, a, b = line.strip().split()
        trials.append((int(label), a, b))
    return trials


def prepare_voxceleb1_sv(workspace, voxceleb1: str, trial_file: str = None):
    """Train on dev speakers (all of wav/ minus test speakers), test on trials."""
    root = Path(voxceleb1)
    trial_file = Path(trial_file) if trial_file else root / "veri_test_v2.txt"
    trials = parse_trials(trial_file)
    test_utts = sorted({u for _, a, b in trials for u in (a, b)})
    test_spks = {u.split("/")[0] for u in test_utts}
    rows = []
    for wav in sorted((root / "wav").glob("id*/*/*.wav")):
        rel = "/".join(wav.parts[-3:])
        spk = wav.parts[-3]
        if spk in test_spks:
            continue
        rows.append(dict(id=rel.replace("/", "-"), wav_path=str(wav), label=spk))
    workspace = Path(workspace)
    pd.DataFrame(rows).to_csv(workspace / "train.csv", index=False)
    pd.DataFrame(
        [dict(id=u.replace("/", "-"), wav_path=str(root / "wav" / u), label=u.split("/")[0]) for u in test_utts]
    ).to_csv(workspace / "test.csv", index=False)
    pd.DataFrame(trials, columns=["label", "enroll", "test"]).to_csv(
        workspace / "trials.csv", index=False
    )
