"""Pseudo audio generation for tests and probing (a copy of s3prl_tpu/util/pseudo_data.py).

Mirrors the reference's util/pseudo_data.py:25-48 (`pseudo_audio` /
`get_pseudo_wavs`): deterministic random waveforms of given second lengths at
16 kHz, returned as numpy arrays plus their sample lengths.
"""

from __future__ import annotations

import tempfile
import wave
from contextlib import contextmanager
from pathlib import Path
from typing import List, Tuple

import numpy as np

SAMPLE_RATE = 16000


def get_pseudo_wavs(
    seed: int = 0,
    n: int = 2,
    secs: Tuple[float, ...] = (2.0, 1.5),
    sample_rate: int = SAMPLE_RATE,
) -> List[np.ndarray]:
    rng = np.random.RandomState(seed)
    secs = list(secs)[:n] + [secs[-1]] * max(0, n - len(secs))
    return [rng.randn(int(s * sample_rate)).astype(np.float32) for s in secs]


def _write_wav(path: Path, wav: np.ndarray, sample_rate: int = SAMPLE_RATE) -> None:
    pcm = np.clip(wav, -1.0, 1.0)
    pcm = (pcm * 32767.0).astype("<i2")
    with wave.open(str(path), "wb") as f:
        f.setnchannels(1)
        f.setsampwidth(2)
        f.setframerate(sample_rate)
        f.writeframes(pcm.tobytes())


@contextmanager
def pseudo_audio(secs: List[float], sample_rate: int = SAMPLE_RATE, seed: int = 0):
    """Write pseudo wav files to a temp dir; yields (paths, num_samples).

    Same contract as the reference's `pseudo_audio` context manager used by
    its integration tests (test/integration/test_superb.py).
    """
    wavs = get_pseudo_wavs(seed=seed, n=len(secs), secs=tuple(secs), sample_rate=sample_rate)
    # scale noise into [-1, 1) so 16-bit quantization keeps the signal
    wavs = [w / max(1e-8, np.abs(w).max()) * 0.5 for w in wavs]
    with tempfile.TemporaryDirectory() as tmpdir:
        paths = []
        for i, w in enumerate(wavs):
            p = Path(tmpdir) / f"pseudo_{i}.wav"
            _write_wav(p, w, sample_rate)
            paths.append(str(p))
        yield paths, [len(w) for w in wavs]
