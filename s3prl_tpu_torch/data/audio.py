"""Audio file loading (a copy of s3prl_tpu/data/audio.py).

The reference loads audio through torchaudio's sox/soundfile C++ backends
(s3prl/dataio/dataset/load_audio.py:13). Here: PCM WAV via the stdlib `wave`
module + numpy (zero-copy frombuffer); FLAC via the first-party C++ decoder
(native/flac_decode.cc, bound in data/flac.py), so LibriSpeech/VoxCeleb load
without preconversion; optional resampling via scipy.signal.resample_poly
(polyphase, matches torchaudio's `resample` kaiser-window quality closely).
"""

from __future__ import annotations

import wave
from math import gcd
from typing import Optional, Tuple

import numpy as np

from .flac import flac_info, load_flac


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


def _load_flac_mono(path, start_sec, end_sec) -> Tuple[np.ndarray, int]:
    samples, sr, bps = load_flac(path)
    wav = samples.astype(np.float32) / float(1 << (bps - 1))
    if wav.shape[1] > 1:
        wav = wav.mean(axis=1)
    else:
        wav = wav[:, 0]
    start = int((start_sec or 0.0) * sr)
    end = len(wav) if end_sec is None else int(end_sec * sr)
    return wav[start:end], sr


def _resample(wav: np.ndarray, sr: int, target_sample_rate: Optional[int]
              ) -> Tuple[np.ndarray, int]:
    if not target_sample_rate or target_sample_rate == sr:
        return wav, sr
    g = gcd(target_sample_rate, sr)
    from scipy.signal import resample_poly  # slow to import: only where it resamples

    return resample_poly(wav, target_sample_rate // g, sr // g).astype(np.float32), \
        target_sample_rate


def load_wav(
    path,
    target_sample_rate: Optional[int] = None,
    start_sec: Optional[float] = None,
    end_sec: Optional[float] = None,
) -> Tuple[np.ndarray, int]:
    """Load a PCM wav or FLAC -> (mono float32 in [-1, 1], sample_rate)."""
    if _is_flac(path):
        return _resample(*_load_flac_mono(path, start_sec, end_sec), target_sample_rate)
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
    return _resample(wav, sr, target_sample_rate)


def audio_info(path) -> dict:
    if _is_flac(path):
        return flac_info(path)
    with wave.open(str(path), "rb") as f:
        return dict(
            sample_rate=f.getframerate(),
            num_frames=f.getnframes(),
            num_channels=f.getnchannels(),
            duration=f.getnframes() / f.getframerate(),
        )
