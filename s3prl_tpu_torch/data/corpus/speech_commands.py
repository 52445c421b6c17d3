"""Google Speech Commands v1 parser (SUPERB KS) (a copy of s3prl_tpu/data/corpus/speech_commands.py).

Behavioral spec from the reference's parser (s3prl/dataio/corpus/
speech_commands.py): ten target words + `_unknown_` + `_silence_`;
validation/testing lists from the official txt files; silence examples are
1-second crops of the _background_noise_ recordings.
"""

from __future__ import annotations

from pathlib import Path

import pandas as pd

TARGET_WORDS = ["yes", "no", "up", "down", "left", "right", "on", "off", "stop", "go"]


def prepare_speech_commands(workspace, speech_commands: str, test_dir: str = None):
    root = Path(speech_commands)
    valid_list = set((root / "validation_list.txt").read_text().split())
    test_list = set((root / "testing_list.txt").read_text().split())

    def label_of(rel: str) -> str:
        word = rel.split("/")[0]
        if word in TARGET_WORDS:
            return word
        if word == "_background_noise_":
            return "_silence_"
        return "_unknown_"

    rows = {"train": [], "valid": [], "test": []}
    for wav in sorted(root.glob("*/*.wav")):
        rel = "/".join(wav.parts[-2:])
        if wav.parts[-2] == "_background_noise_":
            # 1-second silence crops, training only (reference resamples these)
            from ..audio import audio_info

            dur = audio_info(wav)["duration"]
            for start in range(0, int(dur) - 1):
                rows["train"].append(
                    dict(id=f"{rel}-{start}", wav_path=str(wav), label="_silence_",
                         start_sec=float(start), end_sec=float(start + 1))
                )
            continue
        split = "valid" if rel in valid_list else "test" if rel in test_list else "train"
        rows[split].append(dict(id=rel.replace("/", "-"), wav_path=str(wav), label=label_of(rel)))

    workspace = Path(workspace)
    for split, data in rows.items():
        pd.DataFrame(data).to_csv(workspace / f"{split}.csv", index=False)
