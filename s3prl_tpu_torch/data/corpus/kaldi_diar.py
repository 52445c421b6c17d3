"""Kaldi-style diarization data dirs -> chunked frame-label CSV (a copy of
s3prl_tpu/data/corpus/kaldi_diar.py).

Behavioral spec from the reference's SD data pipeline
(s3prl/dataio/dataset/frame_label.py:23-142 + downstream/diarization): a
data dir holds `wav.scp` (reco_id path), `segments` (utt reco start end) and
`utt2spk` (utt spk); frame-level speaker-activity labels are rasterized at
the upstream frame shift and each recording is cut into fixed windows
(`chunk_size` frames) so every batch item has a static shape.

`FRAME_SHIFT` is 160 samples, half the trunks' stride of 320; the SD task
cuts the labels to the states' frames, so label frame i is scored against
state i (the JAX package's behaviour, kept as it is).
"""

from __future__ import annotations

from pathlib import Path
from typing import Dict, List, Tuple

import numpy as np
import pandas as pd

FRAME_SHIFT = 160  # samples per frame @ 16 kHz


def parse_kaldi_dir(data_dir) -> Dict[str, dict]:
    data_dir = Path(data_dir)
    wavs = {}
    for line in (data_dir / "wav.scp").read_text().splitlines():
        reco, _, path = line.strip().partition(" ")
        wavs[reco] = dict(path=path.strip(), segments=[])
    utt2spk = {}
    for line in (data_dir / "utt2spk").read_text().splitlines():
        utt, _, spk = line.strip().partition(" ")
        utt2spk[utt] = spk.strip()
    for line in (data_dir / "segments").read_text().splitlines():
        utt, reco, start, end = line.strip().split()
        wavs[reco]["segments"].append((utt2spk[utt], float(start), float(end)))
    return wavs


def rasterize_labels(
    segments: List[Tuple[str, float, float]],
    num_frames: int,
    speakers: List[str],
    sample_rate: int = 16000,
    frame_shift: int = FRAME_SHIFT,
) -> np.ndarray:
    """[num_frames, num_speakers] binary activity."""
    labels = np.zeros((num_frames, len(speakers)), np.int32)
    spk_index = {s: i for i, s in enumerate(speakers)}
    for spk, start, end in segments:
        if spk not in spk_index:
            continue
        f0 = int(start * sample_rate / frame_shift)
        f1 = int(end * sample_rate / frame_shift)
        labels[f0 : min(f1, num_frames), spk_index[spk]] = 1
    return labels


def prepare_diarization(
    workspace,
    train_dir: str,
    valid_dir: str = None,
    test_dir: str = None,
    chunk_size: int = 2000,  # frames per training chunk
    num_speakers: int = 2,
):
    """Write {split}.csv with one row per chunk: reco, start/end sec, npy label."""
    workspace = Path(workspace)
    label_dir = workspace / "labels"
    label_dir.mkdir(parents=True, exist_ok=True)
    from ..audio import audio_info

    for split, d in [("train", train_dir), ("valid", valid_dir), ("test", test_dir)]:
        if d is None:
            continue
        recos = parse_kaldi_dir(d)
        rows = []
        for reco, info in recos.items():
            speakers = sorted({s for s, _, _ in info["segments"]})[:num_speakers]
            n_samples = audio_info(info["path"])["num_frames"]
            n_frames = n_samples // FRAME_SHIFT
            labels = rasterize_labels(info["segments"], n_frames, speakers)
            for c0 in range(0, max(n_frames - chunk_size, 0) + 1, chunk_size):
                c1 = min(c0 + chunk_size, n_frames)
                label_path = label_dir / f"{split}_{reco}_{c0}.npy"
                np.save(label_path, labels[c0:c1])
                rows.append(
                    dict(
                        id=f"{reco}-{c0}",
                        reco=reco,
                        wav_path=info["path"],
                        start_sec=c0 * FRAME_SHIFT / 16000,
                        end_sec=c1 * FRAME_SHIFT / 16000,
                        label_path=str(label_path),
                    )
                )
        pd.DataFrame(rows).to_csv(workspace / f"{split}.csv", index=False)
