"""Kaldi-compliance acoustic front ends and the STFT (port of
s3prl_tpu/ops/audio.py).

The semantics of ``torchaudio.compliance.kaldi.{fbank,mfcc,spectrogram}``
(the reference's baseline upstream, s3prl/upstream/baseline/extracter.py)
rebuilt from the published Kaldi math, the delta and CMVN transforms on top,
the torch.stft-style hann spectrogram and log-mel of the Mockingjay/TERA
front end, and the complex STFT / iSTFT of the enhancement and separation
tasks.

Everything is batched: padded ``wavs [B, T]`` with ``wav_lens [B]`` in,
padded ``feats [B, F, D]`` with ``feat_lens [B]`` out. Frames at or beyond
an utterance's valid length hold its last valid frame (frame 0 for an
utterance with none), which gives the delta window Kaldi's replicate edge
and pre-satisfies the upstream's repeat-last-frame rule.

All of it is plain tensor code on the waves' device, in f32: framing is
``Tensor.unfold`` (a view, no arithmetic: a conv would run the waveform
through TF32 on the card), the FFTs are ``torch.fft`` (cuFFT on the card),
the mel and DCT products run with TF32 off, and the numpy tables (windows,
mel banks, DCT, lifter) are built once and kept on each device they are
used on. Defaults follow Kaldi: 25 ms povey window, 10 ms shift,
snip_edges, preemphasis 0.97, DC offset removal, FFT size rounded up to a
power of two, no dither.
"""

from __future__ import annotations

import functools
import math
from typing import Optional

import numpy as np
import torch
import torch.nn.functional as F

from .dtw import ieee_matmul

SAMPLE_RATE = 16000
EPSILON = float(np.finfo(np.float32).eps)


def _on(table_fn, *args, device) -> torch.Tensor:
    """The numpy table ``table_fn(*args)`` as a tensor on `device`, made
    once per (table, device)."""
    return _device_table(table_fn, args, torch.device(device))


@functools.lru_cache(maxsize=None)
def _device_table(table_fn, args, device: torch.device) -> torch.Tensor:
    return torch.from_numpy(np.ascontiguousarray(table_fn(*args))).to(device)


# ---------------------------------------------------------------------------
# windows / framing
# ---------------------------------------------------------------------------


def _next_pow2(n: int) -> int:
    return 1 << (n - 1).bit_length()


def feature_window(window_type: str, size: int) -> np.ndarray:
    n = np.arange(size, dtype=np.float64)
    if window_type == "hanning":
        w = 0.5 - 0.5 * np.cos(2 * np.pi * n / (size - 1))
    elif window_type == "hamming":
        w = 0.54 - 0.46 * np.cos(2 * np.pi * n / (size - 1))
    elif window_type == "povey":  # like hanning but goes to zero at edges
        w = (0.5 - 0.5 * np.cos(2 * np.pi * n / (size - 1))) ** 0.85
    elif window_type == "rectangular":
        w = np.ones(size)
    elif window_type == "blackman":
        coeff = 0.42
        a = 2 * np.pi / (size - 1)
        w = coeff - 0.5 * np.cos(a * n) + (0.5 - coeff) * np.cos(2 * a * n)
    else:
        raise ValueError(f"unknown window type {window_type}")
    return w.astype(np.float32)


def num_frames(num_samples, frame_length: int, frame_shift: int, snip_edges: bool = True):
    """Frame counts of sample counts (a tensor), Kaldi's rule."""
    if snip_edges:
        return torch.where(num_samples < frame_length, 0,
                           1 + torch.div(num_samples - frame_length, frame_shift,
                                         rounding_mode="floor"))
    return (num_samples + frame_shift // 2) // frame_shift


def frame_wavs(wavs: torch.Tensor, frame_length: int, frame_shift: int) -> torch.Tensor:
    """wavs [B, T] -> frames [B, F, frame_length] (snip edges), a strided
    view of the waves."""
    B, T = wavs.shape
    if T < frame_length:
        return wavs.new_zeros((B, 0, frame_length))
    return wavs.unfold(1, frame_length, frame_shift)


# ---------------------------------------------------------------------------
# mel filterbank (Kaldi variant: 1127*ln(1+f/700), triangular in mel domain)
# ---------------------------------------------------------------------------


def _mel_scale(freq):
    return 1127.0 * np.log(1.0 + np.asarray(freq, dtype=np.float64) / 700.0)


def kaldi_mel_banks(
    num_bins: int,
    padded_window_size: int,
    sample_rate: float = SAMPLE_RATE,
    low_freq: float = 20.0,
    high_freq: float = 0.0,
) -> np.ndarray:
    """Kaldi mel filterbank matrix, [num_bins, padded_window_size // 2 + 1];
    the last (Nyquist) column is zero, as Kaldi sums over
    padded_window_size // 2 bins."""
    num_fft_bins = padded_window_size // 2
    nyquist = 0.5 * sample_rate
    if high_freq <= 0.0:
        high_freq = nyquist + high_freq
    assert 0.0 <= low_freq < high_freq <= nyquist
    fft_bin_width = sample_rate / padded_window_size
    mel_low = _mel_scale(low_freq)
    mel_high = _mel_scale(high_freq)
    mel_delta = (mel_high - mel_low) / (num_bins + 1)

    bin_mels = _mel_scale(fft_bin_width * np.arange(num_fft_bins))  # [nfft]
    left = mel_low + np.arange(num_bins)[:, None] * mel_delta
    center = left + mel_delta
    right = center + mel_delta
    up = (bin_mels[None, :] - left) / (center - left)
    down = (right - bin_mels[None, :]) / (right - center)
    weights = np.maximum(0.0, np.minimum(up, down))
    out = np.zeros((num_bins, num_fft_bins + 1), dtype=np.float32)
    out[:, :num_fft_bins] = weights
    return out


def kaldi_dct_matrix(num_ceps: int, num_mel_bins: int) -> np.ndarray:
    """Orthonormal DCT-II rows 0..num_ceps-1, [num_mel_bins, num_ceps]."""
    n = np.arange(num_mel_bins, dtype=np.float64)
    k = np.arange(num_ceps, dtype=np.float64)
    dct = np.cos(np.pi / num_mel_bins * (n[:, None] + 0.5) * k[None, :])
    dct *= np.sqrt(2.0 / num_mel_bins)
    dct[:, 0] *= 1.0 / np.sqrt(2.0)
    return dct.astype(np.float32)


def _lifter_coeffs(num_ceps: int, cepstral_lifter: float) -> np.ndarray:
    i = np.arange(num_ceps, dtype=np.float64)
    return (1.0 + 0.5 * cepstral_lifter * np.sin(np.pi * i / cepstral_lifter)).astype(
        np.float32
    )


# ---------------------------------------------------------------------------
# core spectrogram pipeline
# ---------------------------------------------------------------------------


def _batched(wavs: torch.Tensor, wav_lens: Optional[torch.Tensor]):
    """wavs as f32 [B, T] and wav_lens as a tensor on the waves' device."""
    if wavs.ndim == 1:
        wavs = wavs[None]
    wavs = wavs.float()
    if wav_lens is None:
        wav_lens = torch.full((wavs.shape[0],), wavs.shape[1], dtype=torch.int64,
                              device=wavs.device)
    return wavs, torch.as_tensor(wav_lens, device=wavs.device)


def _windowed_frames(
    wavs: torch.Tensor,
    frame_length_ms: float,
    frame_shift_ms: float,
    sample_rate: float,
    window_type: str,
    preemphasis_coefficient: float,
    remove_dc_offset: bool,
    round_to_power_of_two: bool,
):
    frame_length = int(frame_length_ms * sample_rate / 1000.0)
    frame_shift = int(frame_shift_ms * sample_rate / 1000.0)
    frames = frame_wavs(wavs, frame_length, frame_shift)
    if remove_dc_offset:
        frames = frames - frames.mean(dim=-1, keepdim=True)
    if preemphasis_coefficient != 0.0:
        # x[i] -= coeff * x[i-1]; the first sample uses itself as its left
        # neighbor (Kaldi convention)
        prev = torch.cat([frames[..., :1], frames[..., :-1]], dim=-1)
        frames = frames - preemphasis_coefficient * prev
    frames = frames * _on(feature_window, window_type, frame_length, device=wavs.device)
    padded = _next_pow2(frame_length) if round_to_power_of_two else frame_length
    if padded > frame_length:
        frames = F.pad(frames, (0, padded - frame_length))
    return frames, frame_length, frame_shift, padded


def _power_spectrum(frames: torch.Tensor) -> torch.Tensor:
    spec = torch.fft.rfft(frames.float(), dim=-1)
    return spec.real ** 2 + spec.imag ** 2


def _fill_tail_with_last_valid(feats: torch.Tensor, feat_lens: torch.Tensor) -> torch.Tensor:
    """Frames at t >= len replaced by each utterance's last valid frame
    (frame 0 where len is 0)."""
    B, Fr, D = feats.shape
    if Fr == 0:
        return feats
    last_idx = torch.clamp(feat_lens - 1, 0, Fr - 1).long()
    last = torch.gather(feats, 1, last_idx[:, None, None].expand(B, 1, D))  # [B, 1, D]
    t = torch.arange(Fr, device=feats.device)[None, :, None]
    return torch.where(t < feat_lens[:, None, None], feats, last)


def spectrogram(
    wavs: torch.Tensor,
    wav_lens: Optional[torch.Tensor] = None,
    *,
    sample_rate: float = SAMPLE_RATE,
    frame_length: float = 25.0,
    frame_shift: float = 10.0,
    window_type: str = "povey",
    preemphasis_coefficient: float = 0.97,
    remove_dc_offset: bool = True,
    round_to_power_of_two: bool = True,
):
    """Kaldi log power spectrogram: (feats [B, F, nfft // 2 + 1], feat_lens [B])."""
    wavs, wav_lens = _batched(wavs, wav_lens)
    frames, flen, fshift, _ = _windowed_frames(
        wavs, frame_length, frame_shift, sample_rate, window_type,
        preemphasis_coefficient, remove_dc_offset, round_to_power_of_two,
    )
    feats = torch.log(torch.clamp(_power_spectrum(frames), min=EPSILON))
    feat_lens = num_frames(wav_lens, flen, fshift).to(torch.int32)
    return _fill_tail_with_last_valid(feats, feat_lens), feat_lens


def fbank(
    wavs: torch.Tensor,
    wav_lens: Optional[torch.Tensor] = None,
    *,
    num_mel_bins: int = 23,
    sample_rate: float = SAMPLE_RATE,
    frame_length: float = 25.0,
    frame_shift: float = 10.0,
    window_type: str = "povey",
    preemphasis_coefficient: float = 0.97,
    remove_dc_offset: bool = True,
    round_to_power_of_two: bool = True,
    low_freq: float = 20.0,
    high_freq: float = 0.0,
    use_log_fbank: bool = True,
    use_power: bool = True,
):
    """Kaldi-compliance log-mel filterbank: (feats [B, F, num_mel_bins],
    feat_lens [B]); padded frames hold each utterance's last valid frame."""
    wavs, wav_lens = _batched(wavs, wav_lens)
    frames, flen, fshift, padded = _windowed_frames(
        wavs, frame_length, frame_shift, sample_rate, window_type,
        preemphasis_coefficient, remove_dc_offset, round_to_power_of_two,
    )
    power = _power_spectrum(frames)
    if not use_power:
        power = torch.sqrt(power)
    banks = _on(kaldi_mel_banks, num_mel_bins, padded, sample_rate, low_freq, high_freq,
                device=wavs.device)
    with ieee_matmul():
        mel = torch.einsum("bfk,mk->bfm", power, banks)
    if use_log_fbank:
        mel = torch.log(torch.clamp(mel, min=EPSILON))
    feat_lens = num_frames(wav_lens, flen, fshift).to(torch.int32)
    return _fill_tail_with_last_valid(mel, feat_lens), feat_lens


def mfcc(
    wavs: torch.Tensor,
    wav_lens: Optional[torch.Tensor] = None,
    *,
    num_ceps: int = 13,
    num_mel_bins: int = 23,
    cepstral_lifter: float = 22.0,
    sample_rate: float = SAMPLE_RATE,
    frame_length: float = 25.0,
    frame_shift: float = 10.0,
    window_type: str = "povey",
    preemphasis_coefficient: float = 0.97,
    remove_dc_offset: bool = True,
    round_to_power_of_two: bool = True,
    low_freq: float = 20.0,
    high_freq: float = 0.0,
):
    """Kaldi-compliance MFCC: (feats [B, F, num_ceps], feat_lens [B])."""
    logmel, feat_lens = fbank(
        wavs, wav_lens,
        num_mel_bins=num_mel_bins, sample_rate=sample_rate,
        frame_length=frame_length, frame_shift=frame_shift,
        window_type=window_type, preemphasis_coefficient=preemphasis_coefficient,
        remove_dc_offset=remove_dc_offset, round_to_power_of_two=round_to_power_of_two,
        low_freq=low_freq, high_freq=high_freq, use_log_fbank=True, use_power=True,
    )
    with ieee_matmul():
        ceps = logmel @ _on(kaldi_dct_matrix, num_ceps, num_mel_bins, device=logmel.device)
    if cepstral_lifter != 0.0:
        ceps = ceps * _on(_lifter_coeffs, num_ceps, cepstral_lifter, device=ceps.device)
    return ceps, feat_lens


# ---------------------------------------------------------------------------
# deltas + CMVN (reference: baseline/extracter.py Delta/CMVN)
# ---------------------------------------------------------------------------


def compute_deltas(feats: torch.Tensor, win_length: int = 5) -> torch.Tensor:
    """Regression deltas over time with replicate padding (torchaudio's
    compute_deltas): delta_t = sum_n n (x[t+n] - x[t-n]) / (2 sum n^2),
    n = 1..(win_length - 1) // 2. feats [B, F, D]; its padded tail must
    already hold the last valid frame (`_fill_tail_with_last_valid`)."""
    n = (win_length - 1) // 2
    denom = 2 * sum(i * i for i in range(1, n + 1))
    kernel = torch.arange(-n, n + 1, dtype=feats.dtype, device=feats.device) / denom
    left = feats[:, :1, :].expand(-1, n, -1)
    right = feats[:, -1:, :].expand(-1, n, -1)
    padded = torch.cat([left, feats, right], dim=1)  # [B, F + 2n, D]
    out = torch.zeros_like(feats)
    for k in range(2 * n + 1):
        out = out + kernel[k] * padded[:, k:k + feats.shape[1]]
    return out


def add_deltas(feats: torch.Tensor, order: int = 2, win_length: int = 5) -> torch.Tensor:
    """feats with its deltas up to `order`, concatenated on the feature axis."""
    outs = [feats]
    for _ in range(order):
        outs.append(compute_deltas(outs[-1], win_length))
    return torch.cat(outs, dim=-1)


def cmvn(
    feats: torch.Tensor,
    feat_lens: Optional[torch.Tensor] = None,
    eps: float = 1e-10,
) -> torch.Tensor:
    """Per-utterance mean / variance normalization over the valid frames:
    (x - mean) / (eps + std), the unbiased std (the reference's CMVN,
    baseline/extracter.py:78-92); an utterance with no valid frame divides
    by max(n, 1) and max(n - 1, 1)."""
    B, Fr, D = feats.shape
    if feat_lens is None:
        mean = feats.mean(dim=1, keepdim=True)
        var = ((feats - mean) ** 2).sum(dim=1, keepdim=True) / max(Fr - 1, 1)
    else:
        mask = (torch.arange(Fr, device=feats.device)[None, :] < feat_lens[:, None])[..., None]
        denom = torch.clamp(feat_lens[:, None, None], min=1).to(feats.dtype)
        mean = (feats * mask).sum(dim=1, keepdim=True) / denom
        var = torch.where(mask, (feats - mean) ** 2, 0.0).sum(dim=1, keepdim=True) / (
            torch.clamp(denom - 1.0, min=1.0))
    return (feats - mean) / (eps + torch.sqrt(var))


# ---------------------------------------------------------------------------
# STFT path (torch.stft-style, hann window, center + reflect): the
# Mockingjay/TERA mel front end (reference: baseline/preprocessor.py:64-110)
# ---------------------------------------------------------------------------


def _reflect_index(T: int, pad: int) -> np.ndarray:
    """numpy's ``pad(mode="reflect")`` of a length-T axis by `pad` on each
    side as source indices: a mirror of period 2 (T - 1), so a pad longer
    than the axis reflects again (an axis of one sample repeats it)."""
    idx = np.arange(-pad, T + pad)
    if T == 1:
        return np.zeros_like(idx)
    m = np.abs(idx) % (2 * (T - 1))
    return np.where(m >= T, 2 * (T - 1) - m, m)


def _reflect_pad(wavs: torch.Tensor, pad: int) -> torch.Tensor:
    T = wavs.shape[1]
    if pad < T:
        return F.pad(wavs[:, None], (pad, pad), mode="reflect")[:, 0]
    return wavs[:, _on(_reflect_index, T, pad, device=wavs.device)]


def _centered_hann(n_fft: int, win_length: int) -> np.ndarray:
    """A periodic hann of win_length, zero-padded to the centre of n_fft."""
    win = np.zeros(n_fft, dtype=np.float32)
    n = np.arange(win_length)
    hann = (0.5 - 0.5 * np.cos(2 * np.pi * n / win_length)).astype(np.float32)
    start = (n_fft - win_length) // 2
    win[start:start + win_length] = hann
    return win


def _centered_frames(wavs: torch.Tensor, n_fft: int, hop_length: int, win_length: int):
    """Reflect-padded frames centred at t * hop, windowed: [B, 1 + T // hop, n_fft]."""
    frames = frame_wavs(_reflect_pad(wavs.float(), n_fft // 2), n_fft, hop_length)
    return frames * _on(_centered_hann, n_fft, win_length, device=wavs.device)


def stft_spectrogram(
    wavs: torch.Tensor,
    wav_lens: Optional[torch.Tensor] = None,
    *,
    n_fft: int = 400,
    hop_length: int = 160,
    win_length: int = 400,
    power: float = 2.0,
    sample_rate: float = SAMPLE_RATE,
):
    """Centre-padded (reflect) hann STFT magnitude ** power: (spec [B, F,
    n_fft // 2 + 1], feat_lens [B] = wav_lens // hop + 1)."""
    wavs, wav_lens = _batched(wavs, wav_lens)
    frames = _centered_frames(wavs, n_fft, hop_length, win_length)
    spec = torch.abs(torch.fft.rfft(frames, dim=-1)) ** power
    feat_lens = (torch.div(wav_lens, hop_length, rounding_mode="floor") + 1).to(torch.int32)
    return spec, feat_lens


def mel_scale_matrix(
    n_freqs: int,
    n_mels: int,
    sample_rate: float = SAMPLE_RATE,
    f_min: float = 0.0,
    f_max: Optional[float] = None,
) -> np.ndarray:
    """HTK-style mel filterbank (torchaudio.transforms.MelScale), [n_freqs, n_mels]."""
    f_max = f_max or sample_rate / 2
    m_min = 2595.0 * math.log10(1.0 + f_min / 700.0)
    m_max = 2595.0 * math.log10(1.0 + f_max / 700.0)
    m_pts = np.linspace(m_min, m_max, n_mels + 2)
    f_pts = 700.0 * (10.0 ** (m_pts / 2595.0) - 1.0)
    all_freqs = np.linspace(0, sample_rate // 2, n_freqs)
    f_diff = f_pts[1:] - f_pts[:-1]
    slopes = f_pts[None, :] - all_freqs[:, None]
    down = -slopes[:, :-2] / f_diff[:-1]
    up = slopes[:, 2:] / f_diff[1:]
    fb = np.maximum(0.0, np.minimum(down, up))
    return fb.astype(np.float32)


def log_mel(
    wavs: torch.Tensor,
    wav_lens: Optional[torch.Tensor] = None,
    *,
    n_fft: int = 400,
    hop_length: int = 160,
    win_length: int = 400,
    n_mels: int = 80,
    sample_rate: float = SAMPLE_RATE,
    eps: float = 1e-10,
):
    """log(mel(stft^2) + eps): the Mockingjay/TERA on-the-fly mel front end."""
    spec, feat_lens = stft_spectrogram(
        wavs, wav_lens, n_fft=n_fft, hop_length=hop_length,
        win_length=win_length, power=2.0, sample_rate=sample_rate,
    )
    with ieee_matmul():
        mel = spec @ _on(mel_scale_matrix, spec.shape[-1], n_mels, sample_rate,
                         device=spec.device)
    return torch.log(mel + eps), feat_lens


# ---------------------------------------------------------------------------
# complex STFT / iSTFT (the enhancement and separation reconstruction paths;
# reference tasks: s3prl/downstream/enhancement_stft, separation_stft)
# ---------------------------------------------------------------------------


def stft_complex(
    wavs: torch.Tensor,
    *,
    n_fft: int = 512,
    hop_length: int = 160,
    win_length: int = 400,
) -> torch.Tensor:
    """Centre-padded (reflect) hann STFT: complex [B, 1 + T // hop, n_fft // 2 + 1]."""
    if wavs.ndim == 1:
        wavs = wavs[None]
    return torch.fft.rfft(_centered_frames(wavs, n_fft, hop_length, win_length), dim=-1)


def _ola_norm(n_fft: int, hop_length: int, win_length: int, n_frames: int) -> np.ndarray:
    """max(sum of the squared windows over each sample, 1e-8), [n_fft + hop (F - 1)]."""
    win2 = _centered_hann(n_fft, win_length).astype(np.float64) ** 2
    norm = np.zeros(n_fft + hop_length * (n_frames - 1))
    for f in range(n_frames):
        norm[f * hop_length:f * hop_length + n_fft] += win2
    return np.maximum(norm, 1e-8).astype(np.float32)


def _overlap_add(frames: torch.Tensor, hop_length: int) -> torch.Tensor:
    """frames [B, F, n] -> [B, n + hop (F - 1)]: each sample the sum of the
    frames over it, by ``F.fold`` (a gather per output sample, in a fixed
    order: deterministic on the card, unlike an atomic scatter-add)."""
    B, Fr, n = frames.shape
    total = n + hop_length * (Fr - 1)
    out = F.fold(frames.transpose(1, 2), output_size=(1, total), kernel_size=(1, n),
                 stride=(1, hop_length))
    return out.reshape(B, total)


def istft(
    spec: torch.Tensor,  # [B, F, n_fft // 2 + 1] complex
    *,
    n_fft: int = 512,
    hop_length: int = 160,
    win_length: int = 400,
    length: Optional[int] = None,
) -> torch.Tensor:
    """Inverse STFT: hann-windowed overlap-add divided by max(sum of the
    squared windows, 1e-8), the first n_fft // 2 samples cut, then cut to
    `length`. It never pads: F frames give at most n_fft // 2 + hop (F - 1)
    samples, fewer than `length` when the frames fall short (JAX's istft;
    ``torch.istft`` would pad, and raise on a vanishing window sum)."""
    B, Fr, _ = spec.shape
    frames = torch.fft.irfft(spec, n=n_fft, dim=-1)  # [B, F, n_fft]
    frames = frames * _on(_centered_hann, n_fft, win_length, device=frames.device)
    out = _overlap_add(frames, hop_length)
    out = out / _on(_ola_norm, n_fft, hop_length, win_length, Fr, device=out.device)[None]
    out = out[:, n_fft // 2:]
    if length is not None:
        out = out[:, :length]
    return out
