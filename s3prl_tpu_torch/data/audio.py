"""Audio file loading (a copy of s3prl_tpu/data/audio.py for PCM WAV).

PCM WAV via the stdlib `wave` module + numpy, optional resampling via
scipy.signal.resample_poly. FLAC (the JAX package's native decoder,
data/flac.py over native/flac_decode.cc) is not ported: a FLAC file raises.
"""

from __future__ import annotations

import wave
from typing import Optional, Tuple

import numpy as np


def _is_flac(path) -> bool:
    p = str(path)
    if p.lower().endswith(".flac"):
        return True
    if p.lower().endswith(".wav"):
        return False
    try:
        with open(p, "rb") as f:
            return f.read(4) == b"fLaC"
    except OSError:
        return False


def _refuse_flac(path) -> None:
    if _is_flac(path):
        raise NotImplementedError(
            f"{path}: FLAC decoding (data/flac.py, native/flac_decode.cc) is not ported "
            "(ROADMAP.md Queue 1 item 11): convert the corpus to PCM WAV")


def load_wav(
    path,
    target_sample_rate: Optional[int] = None,
    start_sec: Optional[float] = None,
    end_sec: Optional[float] = None,
) -> Tuple[np.ndarray, int]:
    """Load a PCM wav -> (mono float32 in [-1, 1], sample_rate)."""
    _refuse_flac(path)
    with wave.open(str(path), "rb") as f:
        sr = f.getframerate()
        n_channels = f.getnchannels()
        width = f.getsampwidth()
        start = int((start_sec or 0.0) * sr)
        end = f.getnframes() if end_sec is None else int(end_sec * sr)
        f.setpos(min(start, f.getnframes()))
        raw = f.readframes(max(end - start, 0))
    if width == 2:
        wav = np.frombuffer(raw, dtype="<i2").astype(np.float32) / 32768.0
    elif width == 4:
        wav = np.frombuffer(raw, dtype="<i4").astype(np.float32) / 2147483648.0
    elif width == 1:
        wav = (np.frombuffer(raw, dtype=np.uint8).astype(np.float32) - 128.0) / 128.0
    else:
        raise ValueError(f"unsupported sample width {width} in {path}")
    if n_channels > 1:
        wav = wav.reshape(-1, n_channels).mean(axis=1)
    if target_sample_rate and target_sample_rate != sr:
        from scipy.signal import resample_poly
        from math import gcd

        g = gcd(target_sample_rate, sr)
        wav = resample_poly(wav, target_sample_rate // g, sr // g).astype(np.float32)
        sr = target_sample_rate
    return wav, sr


def audio_info(path) -> dict:
    _refuse_flac(path)
    with wave.open(str(path), "rb") as f:
        return dict(
            sample_rate=f.getframerate(),
            num_frames=f.getnframes(),
            num_channels=f.getnchannels(),
            duration=f.getnframes() / f.getframerate(),
        )
