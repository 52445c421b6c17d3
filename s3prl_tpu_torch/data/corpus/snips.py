"""Audio SNIPS corpus parser (SUPERB SF) (a copy of s3prl_tpu/data/corpus/snips.py).

Behavioral spec from the reference (s3prl/dataio/corpus/snips.py:22-126):
`all.iob.snips.txt` maps utterance ids to IOB-tagged transcripts
("word:TAG" pairs rendered as two aligned lines in the reference pipeline;
the raw file holds "<uid> w1 w2 ... EOS\tO O ... O" style entries); wavs
live under {train,valid,test}/<speaker>/ and are filtered by the official
speaker splits.
"""

from __future__ import annotations

from pathlib import Path
from typing import List

import pandas as pd

TRAIN_SPEAKERS = [
    "Ivy", "Joanna", "Joey", "Justin", "Kendra", "Kimberly", "Matthew", "Salli",
]
VALID_SPEAKERS = ["Aditi", "Amy", "Geraint", "Nicole"]
TEST_SPEAKERS = ["Brian", "Emma", "Raveena", "Russell"]


def _parse_iob_file(path) -> dict:
    """uid -> (sentence, iob-tags). The file stores per-word 'text' and a
    parallel IOB sequence separated by a tab (or the reference's combined
    markup); both layouts are handled."""
    out = {}
    for line in Path(path).read_text().splitlines():
        line = line.strip()
        if not line:
            continue
        uid, _, rest = line.partition(" ")
        if "\t" in rest:
            sent, _, iob = rest.partition("\t")
        else:
            # fall back: alternating "word:TAG" tokens
            words, tags = [], []
            for tok in rest.split(" "):
                w, _, t = tok.rpartition(":")
                if not w:
                    w, t = tok, "O"
                words.append(w)
                tags.append(t)
            sent, iob = " ".join(words), " ".join(tags)
        out[uid] = (sent.strip(), iob.strip())
    return out


def prepare_snips(
    workspace,
    snips: str,
    train_speakers: List[str] = None,
    valid_speakers: List[str] = None,
    test_speakers: List[str] = None,
):
    root = Path(snips)
    transcripts = _parse_iob_file(root / "all.iob.snips.txt")
    speakers = {
        "train": train_speakers or TRAIN_SPEAKERS,
        "valid": valid_speakers or VALID_SPEAKERS,
        "test": test_speakers or TEST_SPEAKERS,
    }
    workspace = Path(workspace)
    for split, spk_list in speakers.items():
        rows = []
        for wav in sorted((root / split).rglob("*.wav")):
            uid = wav.stem
            if uid not in transcripts:
                continue
            spk = uid.split("-")[0]
            if spk not in spk_list:
                continue
            sent, iob = transcripts[uid]
            rows.append(
                dict(id=uid, wav_path=str(wav), transcription=sent, iob=iob)
            )
        pd.DataFrame(rows).to_csv(workspace / f"{split}.csv", index=False)
