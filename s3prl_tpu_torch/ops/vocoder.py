"""Griffin-Lim vocoder (port of s3prl_tpu/ops/vocoder.py): waveforms from
the VC task's log-mels, over the same analysis the task trains against
(`ops.audio.log_mel`: n_fft 400, hop 160, power-2 HTK mel):

    log-mel -> mel power (exp) -> linear power (the filter bank's pinv,
    clipped at 0) -> |STFT| -> Griffin-Lim from zero phase -> waveform

peak-normalised to 0.95. The FFTs are ``torch.fft`` (cuFFT on the card),
the STFT / iSTFT those of `ops.audio` (`stft_complex`, `istft`).

The filter bank is ill-conditioned: its pinv's entries cancel in the
product with the mel power, so an f32 product moves the linear power by up
to 0.4% of its peak from one summation order to another (2.8 of 707 on a
220-Hz tone, JAX's f32 against the port's), and the bins it clips to zero
with it. The product runs in float64 here, so the card and the CPU give
the same magnitudes.
"""

from __future__ import annotations

import numpy as np
import torch

from . import audio


def griffin_lim(mag: torch.Tensor, n_fft: int = 400, hop_length: int = 160,
                win_length: int = 400, n_iter: int = 32) -> torch.Tensor:
    """mag [B, F, n_fft // 2 + 1] linear magnitude -> wav [B, hop (F - 1)]:
    `n_iter` rounds of iSTFT then STFT, each keeping the phase of the
    round's spectrum (its ``angle``: 0 for a zero bin), from phase 0."""
    Fr = mag.shape[1]
    length = hop_length * (Fr - 1)
    kw = dict(n_fft=n_fft, hop_length=hop_length, win_length=win_length)
    angle = torch.zeros_like(mag)
    for _ in range(n_iter):
        wav = audio.istft(torch.polar(mag, angle), length=length, **kw)
        angle = torch.angle(audio.stft_complex(wav, **kw)[:, :Fr])
    return audio.istft(torch.polar(mag, angle), length=length, **kw)


def spectral_convergence(wav: torch.Tensor, mag: torch.Tensor, n_fft: int = 400,
                         hop_length: int = 160, win_length: int = 400) -> torch.Tensor:
    """|| |STFT(wav)| - mag ||_F / || mag ||_F over the batch: how far
    `griffin_lim`'s wave is from the magnitudes it was given. Griffin-Lim's
    phases are rounding where the magnitudes are inconsistent, so two FFT
    libraries' waves part after a few rounds while this measure agrees."""
    spec = audio.stft_complex(wav, n_fft=n_fft, hop_length=hop_length,
                              win_length=win_length)[:, :mag.shape[1]]
    return (spec.abs() - mag).norm() / mag.norm()


def _mel_pinv(n_freqs: int, n_mels: int, sample_rate: float) -> np.ndarray:
    """The pseudo-inverse of `audio.mel_scale_matrix`, [n_mels, n_freqs]."""
    return np.linalg.pinv(audio.mel_scale_matrix(n_freqs, n_mels, sample_rate))


def mel_magnitudes(log_mel: torch.Tensor, n_fft: int = 400, n_mels: int = 80,
                   sample_rate: float = audio.SAMPLE_RATE, eps: float = 1e-10) -> torch.Tensor:
    """log_mel [B, F, n_mels] -> linear magnitudes [B, F, n_fft // 2 + 1]:
    the filter bank's pinv on the mel power (float64), clipped at 0, the
    square root."""
    power = torch.exp(log_mel.double()) - eps
    inv = audio._on(_mel_pinv, n_fft // 2 + 1, n_mels, sample_rate, device=log_mel.device)
    return torch.sqrt(torch.clamp(power @ inv.double(), min=0.0).float())


def log_mel_to_wav(log_mel: torch.Tensor, n_fft: int = 400, hop_length: int = 160,
                   win_length: int = 400, n_mels: int = 80,
                   sample_rate: float = audio.SAMPLE_RATE, n_iter: int = 32,
                   eps: float = 1e-10) -> torch.Tensor:
    """log_mel [B, F, n_mels] (`audio.log_mel`'s) -> wav [B, hop (F - 1)]
    on log_mel's device, each row's peak at 0.95."""
    mag = mel_magnitudes(log_mel, n_fft, n_mels, sample_rate, eps)
    wav = griffin_lim(mag, n_fft=n_fft, hop_length=hop_length,
                      win_length=win_length, n_iter=n_iter)
    peak = wav.abs().amax(dim=-1, keepdim=True)
    return wav / torch.clamp(peak, min=1e-6) * 0.95
