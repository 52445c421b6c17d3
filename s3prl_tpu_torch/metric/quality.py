"""First-party speech-quality metrics: STOI and PESQ (a copy of
s3prl_tpu/metric/quality.py: numpy and scipy on the host, no native deps).

The reference computes ``["si_sdr", "stoi", "pesq"]`` for SE/SS through
asteroid's ``get_metrics`` (pystoi + the ITU P.862 C binding) and selects
the SE dev-best checkpoint by PESQ
(s3prl/downstream/enhancement_stft/expert.py:38,299,383-385;
separation_stft2/expert.py:356 uses si_sdr for dev-best). Neither native
package is a dependency, so both metrics are implemented here from their
published algorithm descriptions:

- ``stoi``: Taal, Hendriks, Heusdens, Jensen, "An Algorithm for
  Intelligibility Prediction of Time-Frequency Weighted Noisy Speech"
  (IEEE TASLP 2011). Full algorithm — 10 kHz resample, silent-frame
  removal (40 dB dynamic range), 256/512 hann STFT, 15 one-third-octave
  bands from 150 Hz, 30-frame segments, per-band normalization + (-15 dB)
  clipping, per-band linear correlation. Matches the public pystoi
  constants; the extended (eSTOI) variant is included for completeness.

- ``pesq``: ITU-T P.862 (narrowband) / P.862.2 (wideband) implemented with
  the REFERENCE IMPLEMENTATION'S published perceptual-model tables and
  constants: the 49-band bin partition (``nr_of_hz_bands_per_bark_band``),
  band widths/centres on the P.862 modified bark scale, the 0.1-dB-exact
  absolute-hearing-threshold powers, the power/loudness scalings
  Sp = 6.910853e-6 (wb) / 2.764344e-5 (nb) and Sl = 1.866055e-1, partial
  frequency compensation (+1000 offset, [0.01, 100] clip, applied to the
  reference), smoothed short-term gain compensation ([3e-4, 5] clip,
  applied to the degraded), modified Zwicker loudness (exponent correction
  below 4 bark), 0.25-deadzone disturbance, the (+50)^1.2 asymmetry with
  the <3 cut / 12 cap, bark-width pseudo-Lp over bands, the
  ((P+1e5)/1e7)^0.04 frame emphasis with the 45 clip, half-overlapped
  20-frame L6 "syllable" / L2 time aggregation, and the published
  P.862.1 / P.862.2 logistic MOS-LQO maps. The tables are self-validating
  (tests/test_quality_metrics.py): the bin partition sums exactly to the
  FFT bins, centres satisfy the band-edge recursion against the widths,
  and every threshold power is an exact 0.1-dB decade.

  Documented deviations from the ITU C tool (all immaterial for the SE/SS
  model-selection/reporting use, where estimate and reference share a
  clock): time alignment is one global envelope cross-correlation, not the
  utterance-splitting fine aligner (telephony delay jitter machinery); the
  wideband 100 Hz input high-pass is realized as a 2nd-order Butterworth
  rather than the reference IIR section; the narrowband band tables are
  the wideband tables truncated at 4 kHz (identical construction, final
  band 11 bins). ``pesq_analytic`` keeps the previous fully-analytic
  scorer (Schroeder bark scale, Terhardt thresholds) as a fallback.
"""

from __future__ import annotations

import numpy as np

EPS = np.finfo(np.float64).eps


# ---------------------------------------------------------------------------
# shared DSP helpers
# ---------------------------------------------------------------------------


def _resample(x: np.ndarray, fs_in: int, fs_out: int) -> np.ndarray:
    if fs_in == fs_out:
        return x
    from math import gcd

    from scipy.signal import resample_poly

    g = gcd(fs_in, fs_out)
    return resample_poly(x, fs_out // g, fs_in // g)


def _frame(x: np.ndarray, framelen: int, hop: int) -> np.ndarray:
    """[T] -> [n_frames, framelen] (drops the tail that doesn't fill a frame)."""
    n = 1 + max(0, (len(x) - framelen)) // hop
    idx = np.arange(framelen)[None, :] + hop * np.arange(n)[:, None]
    return x[idx]


# ---------------------------------------------------------------------------
# STOI (Taal et al. 2011)
# ---------------------------------------------------------------------------

_STOI_FS = 10000
_STOI_FRAME = 256
_STOI_NFFT = 512
_STOI_HOP = 128
_STOI_NBANDS = 15
_STOI_MINFREQ = 150
_STOI_SEG = 30  # frames per short-time segment (384 ms)
_STOI_BETA = -15.0  # lower SDR clipping bound (dB)
_STOI_DYN_RANGE = 40.0  # silent-frame energy range (dB)


def _stoi_window() -> np.ndarray:
    # matlab-style hanning(N): the periodic-ish variant without zero endpoints
    return np.hanning(_STOI_FRAME + 2)[1:-1]


def _remove_silent_frames(x: np.ndarray, y: np.ndarray):
    """Drop frames whose CLEAN energy is >40 dB below the loudest frame,
    overlap-adding the survivors back into continuous signals."""
    w = _stoi_window()
    xf = _frame(x, _STOI_FRAME, _STOI_HOP) * w
    yf = _frame(y, _STOI_FRAME, _STOI_HOP) * w
    energies = 20 * np.log10(np.linalg.norm(xf, axis=1) + EPS)
    mask = energies > (np.max(energies) - _STOI_DYN_RANGE)
    xf, yf = xf[mask], yf[mask]
    if len(xf) == 0:
        return np.zeros(0), np.zeros(0)
    n_out = _STOI_HOP * (len(xf) - 1) + _STOI_FRAME
    x_out = np.zeros(n_out)
    y_out = np.zeros(n_out)
    for i in range(len(xf)):  # 50%-overlap hann OLA reconstructs unit gain
        s = i * _STOI_HOP
        x_out[s : s + _STOI_FRAME] += xf[i]
        y_out[s : s + _STOI_FRAME] += yf[i]
    return x_out, y_out


def _thirdoct():
    """One-third-octave band matrix [15, 257] + center freqs, per the STOI
    paper (150 Hz * 2^(k/3) centers snapped to FFT bins)."""
    f = np.linspace(0, _STOI_FS, _STOI_NFFT + 1)[: _STOI_NFFT // 2 + 1]
    k = np.arange(_STOI_NBANDS, dtype=np.float64)
    freq_low = _STOI_MINFREQ * 2.0 ** ((2 * k - 1) / 6)
    freq_high = _STOI_MINFREQ * 2.0 ** ((2 * k + 1) / 6)
    obm = np.zeros((_STOI_NBANDS, len(f)))
    for i in range(_STOI_NBANDS):
        lo = int(np.argmin((f - freq_low[i]) ** 2))
        hi = int(np.argmin((f - freq_high[i]) ** 2))
        obm[i, lo:hi] = 1.0
    return obm


def _stoi_spectrogram(x: np.ndarray) -> np.ndarray:
    w = _stoi_window()
    frames = _frame(x, _STOI_FRAME, _STOI_HOP) * w
    return np.abs(np.fft.rfft(frames, n=_STOI_NFFT, axis=1)) ** 2  # [n, 257]


def stoi(x: np.ndarray, y: np.ndarray, fs_sig: int, extended: bool = False) -> float:
    """Short-Time Objective Intelligibility of degraded ``y`` vs clean ``x``.

    Returns a score in ~[0, 1]; 1.0 for identical signals. ``extended``
    selects eSTOI (Jensen & Taal 2016, spectrally-normalized correlation).
    """
    x = np.asarray(x, np.float64).reshape(-1)
    y = np.asarray(y, np.float64).reshape(-1)
    if x.shape != y.shape:
        n = min(len(x), len(y))
        x, y = x[:n], y[:n]
    x = _resample(x, fs_sig, _STOI_FS)
    y = _resample(y, fs_sig, _STOI_FS)
    x, y = _remove_silent_frames(x, y)
    if len(x) < _STOI_FRAME + _STOI_HOP * (_STOI_SEG - 1):
        return float("nan")  # too short / fully silent (pystoi warns too)

    obm = _thirdoct()
    X = np.sqrt(obm @ _stoi_spectrogram(x).T)  # [15, n_frames]
    Y = np.sqrt(obm @ _stoi_spectrogram(y).T)

    n_frames = X.shape[1]
    n_seg = n_frames - _STOI_SEG + 1
    # short-time segments [n_seg, 15, 30]
    seg_idx = np.arange(_STOI_SEG)[None, :] + np.arange(n_seg)[:, None]
    Xs = np.transpose(X[:, seg_idx], (1, 0, 2))
    Ys = np.transpose(Y[:, seg_idx], (1, 0, 2))

    if extended:
        # eSTOI: row+column normalized segments, correlation over the whole
        # spectrogram segment
        Xn = Xs - Xs.mean(axis=2, keepdims=True)
        Xn /= np.linalg.norm(Xn, axis=2, keepdims=True) + EPS
        Yn = Ys - Ys.mean(axis=2, keepdims=True)
        Yn /= np.linalg.norm(Yn, axis=2, keepdims=True) + EPS
        Xn = Xn - Xn.mean(axis=1, keepdims=True)
        Xn /= np.linalg.norm(Xn, axis=1, keepdims=True) + EPS
        Yn = Yn - Yn.mean(axis=1, keepdims=True)
        Yn /= np.linalg.norm(Yn, axis=1, keepdims=True) + EPS
        return float(np.sum(Xn * Yn / _STOI_SEG) / n_seg)

    # per-band energy normalization of the degraded segment + SDR clipping
    alpha = np.sqrt(
        np.sum(Xs**2, axis=2, keepdims=True) / (np.sum(Ys**2, axis=2, keepdims=True) + EPS)
    )
    Yn = Ys * alpha
    clip = 10 ** (-_STOI_BETA / 20.0)
    Yp = np.minimum(Yn, Xs * (1 + clip))

    Xc = Xs - Xs.mean(axis=2, keepdims=True)
    Yc = Yp - Yp.mean(axis=2, keepdims=True)
    Xc /= np.linalg.norm(Xc, axis=2, keepdims=True) + EPS
    Yc /= np.linalg.norm(Yc, axis=2, keepdims=True) + EPS
    d = np.sum(Xc * Yc, axis=2)  # [n_seg, 15] per-band correlations
    return float(d.mean())


# ---------------------------------------------------------------------------
# PESQ (structured after ITU-T P.862 / P.862.2)
# ---------------------------------------------------------------------------

_PESQ_NBARK = 49
_PESQ_ZWICKER = 0.23
_PESQ_SL = 30.0  # loudness scale: calibrated so AWGN degradations on a
#                  synthetic speech-like signal land in the ITU
#                  implementation's typical score ranges (wb ~3.7 @30 dB SNR,
#                  ~2.4 @20 dB, ~1.9 @10 dB, ~1.6 @0 dB); identity is exact
#                  regardless (zero disturbance short-circuits calibration)


def _bark_of_hz(f):
    return 7.0 * np.arcsinh(np.asarray(f, np.float64) / 650.0)


def _hz_of_bark(z):
    return 650.0 * np.sinh(np.asarray(z, np.float64) / 7.0)


def _abs_thresh_db(f_hz: np.ndarray) -> np.ndarray:
    """Terhardt absolute hearing threshold (dB SPL) per band center."""
    f = np.maximum(f_hz, 20.0) / 1000.0
    return 3.64 * f**-0.8 - 6.5 * np.exp(-0.6 * (f - 3.3) ** 2) + 1e-3 * f**4


def _pesq_geometry(fs: int):
    if fs == 16000:
        nf, fmax = 512, 8000.0
    elif fs == 8000:
        nf, fmax = 256, 4000.0
    else:
        raise ValueError(f"PESQ supports fs in (8000, 16000), got {fs}")
    return nf, fmax


def _bark_bands(fs: int):
    """49 bark bands uniform on the Schroeder scale up to fs/2: returns
    (bin->band assignment [n_bins], band widths in bark, band centers Hz)."""
    nf, fmax = _pesq_geometry(fs)
    n_bins = nf // 2 + 1
    f = np.linspace(0, fs / 2.0, n_bins)
    z_edges = np.linspace(0.0, float(_bark_of_hz(fmax)), _PESQ_NBARK + 1)
    z = _bark_of_hz(f)
    band = np.clip(np.searchsorted(z_edges, z, side="right") - 1, 0, _PESQ_NBARK - 1)
    centers_hz = _hz_of_bark(0.5 * (z_edges[:-1] + z_edges[1:]))
    widths = np.diff(z_edges)
    return band, widths, centers_hz


def _band_pow(power_spec: np.ndarray, band: np.ndarray) -> np.ndarray:
    """[n_frames, n_bins] power -> [n_frames, 49] pitch power densities."""
    out = np.zeros((power_spec.shape[0], _PESQ_NBARK))
    np.add.at(out.T, band, power_spec.T)
    return out


def _level_align(x: np.ndarray, fs: int) -> np.ndarray:
    """Scale to a fixed active level using 325–3250 Hz band power (the
    P.862 level-alignment band)."""
    spec = np.fft.rfft(x)
    f = np.linspace(0, fs / 2.0, len(spec))
    bandpass = (f >= 325) & (f <= 3250)
    band_pow = np.sum(np.abs(spec[bandpass]) ** 2) / max(len(x), 1) ** 2 * 2
    target = 1e-2  # fixed active-band mean-square target
    gain = np.sqrt(target / max(band_pow, 1e-20))
    return x * gain


def _input_filter(x: np.ndarray, fs: int, mode: str) -> np.ndarray:
    """Frequency-domain input filter: wb = 100 Hz high-pass with the
    P.862.2 soft knee; nb = IRS-receive-like telephone bandpass."""
    spec = np.fft.rfft(x)
    f = np.linspace(0, fs / 2.0, len(spec))
    if mode == "wb":
        gain = 1.0 / (1.0 + (100.0 / np.maximum(f, 1e-3)) ** 4)
    else:
        # smooth telephone band emphasis ~300-3100 Hz
        lo = 1.0 / (1.0 + (310.0 / np.maximum(f, 1e-3)) ** 4)
        hi = 1.0 / (1.0 + (f / 3500.0) ** 8)
        gain = lo * hi
    return np.fft.irfft(spec * gain, n=len(x))


def _time_align(ref: np.ndarray, deg: np.ndarray, fs: int) -> np.ndarray:
    """Global delay estimate via cross-correlation of 4 ms energy
    envelopes; shifts ``deg`` onto ``ref``. (The ITU utterance-splitting
    fine alignment matters for telephony delay jitter; SE/SS pipelines
    compare same-clock signals, where a single global delay suffices.)"""
    hop = max(fs // 250, 1)
    n = min(len(ref), len(deg)) // hop
    if n < 8:
        return deg
    er = np.square(ref[: n * hop].reshape(n, hop)).sum(1)
    ed = np.square(deg[: n * hop].reshape(n, hop)).sum(1)
    er -= er.mean()
    ed -= ed.mean()
    corr = np.correlate(ed, er, mode="full")
    delay = (int(np.argmax(corr)) - (n - 1)) * hop
    if delay > 0:
        deg = deg[delay:]
    elif delay < 0:
        deg = np.concatenate([np.zeros(-delay), deg])
    return deg


def _loudness(ppd: np.ndarray, p0: np.ndarray) -> np.ndarray:
    """Zwicker-law loudness density from pitch power density (ITU-T P.862
    perceptual model): Sl*(P0/0.5)^g * ((0.5 + 0.5*P/P0)^g - 1)."""
    g = _PESQ_ZWICKER
    loud = _PESQ_SL * (p0 / 0.5) ** g * ((0.5 + 0.5 * ppd / p0) ** g - 1.0)
    return np.where(ppd > p0, np.maximum(loud, 0.0), 0.0)


def _lp(x: np.ndarray, p: float, axis=-1) -> np.ndarray:
    return np.mean(np.abs(x) ** p, axis=axis) ** (1.0 / p)


def pesq_analytic(ref: np.ndarray, deg: np.ndarray, fs: int = 16000, mode: str | None = None) -> float:
    """Previous fully-analytic PESQ-style scorer (Schroeder bark scale,
    Terhardt thresholds, calibrated loudness scale) — kept as a fallback
    and A/B partner for the table-exact ``pesq``; monotone in degradation
    severity, identity-anchored, NOT ITU-table based."""
    if mode is None:
        mode = "wb" if fs == 16000 else "nb"
    ref = np.asarray(ref, np.float64).reshape(-1)
    deg = np.asarray(deg, np.float64).reshape(-1)

    ref = _level_align(ref - ref.mean(), fs)
    deg = _level_align(deg - deg.mean(), fs)
    ref = _input_filter(ref, fs, mode)
    deg = _input_filter(deg, fs, mode)
    deg = _time_align(ref, deg, fs)
    n = min(len(ref), len(deg))
    ref, deg = ref[:n], deg[:n]

    nf, _ = _pesq_geometry(fs)
    hop = nf // 2
    if n < 2 * nf:
        return float("nan")
    w = np.hanning(nf)
    rf = _frame(ref, nf, hop) * w
    df = _frame(deg, nf, hop) * w
    rp = np.abs(np.fft.rfft(rf, axis=1)) ** 2  # [T, bins]
    dp = np.abs(np.fft.rfft(df, axis=1)) ** 2

    band, widths, centers = _bark_bands(fs)
    rb = _band_pow(rp, band)  # [T, 49] pitch power densities
    db = _band_pow(dp, band)

    # absolute hearing threshold per band, tied to the fixed alignment level
    # (_level_align target ≙ 73 dB SPL active speech level)
    p0 = 10.0 ** ((_abs_thresh_db(centers) - 73.0) / 10.0) * 1e-2

    # speech-active frames: total ref band power above the silence floor
    frame_pow = rb.sum(1)
    active = frame_pow > (frame_pow.max() + EPS) * 1e-4
    if not np.any(active):
        return float("nan")

    # partial frequency compensation: per-band ratio of mean densities over
    # active frames, clipped to +-20 dB, applied to the REFERENCE. The
    # additive offset is scaled to the speech level (the ITU constant plays
    # the same role): bands well below it get ratio ~= 1, so a stationary
    # noise floor is NOT compensated away — only genuine linear filtering
    # of speech-carrying bands is.
    mean_r = rb[active].mean(0)
    mean_d = db[active].mean(0)
    off = 1e-3 * float(mean_r.max()) + EPS
    freq_comp = np.clip((mean_d + off) / (mean_r + off), 0.01, 100.0)
    rb_c = rb * freq_comp[None, :]

    # short-term gain compensation: smoothed frame power ratio, applied to
    # the DEGRADED density
    goff = 1e-2 * float(frame_pow.max()) + EPS
    ratio = (rb_c.sum(1) + goff) / (db.sum(1) + goff)
    gain = np.empty_like(ratio)
    g = 1.0
    for t in range(len(ratio)):
        g = 0.8 * g + 0.2 * ratio[t]
        gain[t] = np.clip(g, 3e-4, 5.0)
    db_c = db * gain[:, None]

    r_loud = _loudness(rb_c, p0[None, :])
    d_loud = _loudness(db_c, p0[None, :])

    # disturbance with masking deadzone
    diff = d_loud - r_loud
    dead = 0.25 * np.minimum(d_loud, r_loud)
    disturbance = np.sign(diff) * np.maximum(np.abs(diff) - dead, 0.0)

    # asymmetry factor: additive (noise) distortions weigh more than
    # components the codec removed
    asym = ((db_c + 50.0 * p0[None, :]) / (rb_c + 50.0 * p0[None, :])) ** 1.2
    asym = np.where(asym < 3.0, 0.0, np.minimum(asym, 12.0))

    wgt = widths[None, :] / widths.sum()
    d_frame = np.sqrt(np.sum(wgt * disturbance**2, axis=1))  # L2 over bands
    da_frame = np.sum(wgt * np.abs(disturbance) * asym, axis=1)  # L1 over bands

    # emphasis against loud-frame dominance + clipping, per P.862
    h = (frame_pow + 1e5 * p0.sum()) ** 0.04
    d_frame = np.minimum(d_frame / h, 45.0)
    da_frame = np.minimum(da_frame / h, 45.0)

    # L6 over 320 ms intervals, L2 over intervals
    span = 20 if fs == 16000 else 10  # frames per 320 ms at 16/32 ms hops
    n_int = max(len(d_frame) // span, 1)
    trim = n_int * span
    d_sym = _lp(_lp(d_frame[:trim].reshape(n_int, span), 6.0, axis=1), 2.0)
    d_asym = _lp(_lp(da_frame[:trim].reshape(n_int, span), 6.0, axis=1), 2.0)

    raw = 4.5 - 0.1 * float(d_sym) - 0.0309 * float(d_asym)
    raw = float(np.clip(raw, -0.5, 4.5))

    if mode == "wb":  # P.862.2 mapping
        return 0.999 + 4.0 / (1.0 + np.exp(-1.3669 * raw + 3.8224))
    # P.862.1 mapping (narrowband)
    return 0.999 + 4.0 / (1.0 + np.exp(-1.4945 * raw + 4.6607))


# ---------------------------------------------------------------------------
# PESQ — ITU-T P.862 / P.862.2 perceptual model with the reference
# implementation's published band tables and constants
# ---------------------------------------------------------------------------
# The tables below are the published P.862 reference-implementation
# perceptual-model tables (16 kHz geometry, Nb=49). They are
# self-validating, and tests/test_quality_metrics.py asserts all three
# invariants at import precision:
#   * the Hz-bin partition sums to exactly Nf/2 = 256 bins of 31.25 Hz
#     (full coverage of 0..8 kHz),
#   * band centres satisfy the band-edge recursion
#     c[i+1] = c[i] + (w[i] + w[i+1]) / 2 against the width table,
#   * every absolute-threshold power is an exact 0.1-dB decade
#     (the published floats are 10^(k/10) for integer tenth-dB k).

#: bins of the Nf=512 rFFT per modified-bark band (sums to 256)
_P862_NR_HZ = np.array([
    1, 1, 1, 1, 1, 1, 1, 1, 2, 1, 1, 1, 1, 1, 2, 1, 1, 2, 2, 2,
    2, 2, 2, 2, 2, 3, 3, 3, 3, 4, 3, 4, 5, 4, 5, 6, 6, 7, 8, 9,
    9, 12, 12, 15, 16, 18, 21, 25, 20])

#: band widths on the P.862 modified bark scale
_P862_WIDTH_BARK = np.array([
    0.157344, 0.317994, 0.322441, 0.326934, 0.331474, 0.336061, 0.340697,
    0.345381, 0.350114, 0.354897, 0.359729, 0.364611, 0.369544, 0.374529,
    0.379565, 0.384653, 0.389794, 0.394989, 0.400236, 0.405538, 0.410894,
    0.416306, 0.421773, 0.427297, 0.432877, 0.438514, 0.444209, 0.449962,
    0.455774, 0.461645, 0.467577, 0.473569, 0.479621, 0.485736, 0.491912,
    0.498151, 0.504454, 0.510819, 0.517250, 0.523745, 0.530308, 0.536934,
    0.543629, 0.550390, 0.557220, 0.564119, 0.571085, 0.578125, 0.585232])

#: band centres (bark); equals the width-table edge recursion to 4e-6
_P862_CENTRE_BARK = np.array([
    0.078672, 0.316341, 0.636559, 0.961246, 1.290450, 1.624217, 1.962597,
    2.305636, 2.653383, 3.005889, 3.363201, 3.725371, 4.092449, 4.464486,
    4.841533, 5.223642, 5.610866, 6.003256, 6.400869, 6.803755, 7.211971,
    7.625571, 8.044611, 8.469146, 8.899232, 9.334927, 9.776288, 10.223374,
    10.676242, 11.134952, 11.599563, 12.070135, 12.546731, 13.029408,
    13.518232, 14.013264, 14.514566, 15.022202, 15.536238, 16.056736,
    16.583761, 17.117382, 17.657663, 18.204674, 18.758478, 19.319147,
    19.886751, 20.461355, 21.043034])

#: absolute hearing threshold per band, in P.862 power units, published as
#: exact 0.1-dB decades (stored as tenth-dB integers)
_P862_ABS_THRESH_DB10 = np.array([
    771, 639, 485, 369, 307, 259, 202, 166, 125, 99, 69, 49, 28, 10, -1,
    -14, -25, -34, -41, -48, -53, -57, -59, -60, -60, -60, -60, -58, -54,
    -51, -47, -43, -40, -36, -33, -31, -30, -30, -29, -28, -28, -28, -29,
    -32, -37, -43, -44, -38, -27])
_P862_ABS_THRESH = 10.0 ** (_P862_ABS_THRESH_DB10 / 100.0)  # tenth-dB ints

#: FFT-power -> pitch-power-density scale (nb value = 4x wb: power per bin
#: of the half-size FFT) and the Zwicker loudness scale
_P862_SP = {16000: 6.910853e-6, 8000: 2.764344e-5}
_P862_SL = 1.866055e-1
_P862_ZWICKER_POWER = 0.23
_P862_TARGET_POWER = 1e7  # fix_power_level target (int16-domain units)

#: IRS receive characteristic (Hz, dB) — the P.862 narrowband input filter
_P862_IRS_RECEIVE_DB = np.array([
    (0, -200.0), (50, -40.0), (100, -20.0), (125, -12.0), (160, -6.0),
    (200, 0.0), (250, 4.0), (300, 6.0), (350, 8.0), (400, 10.0),
    (500, 11.0), (600, 12.0), (700, 12.0), (800, 12.0), (1000, 12.0),
    (1300, 12.0), (1600, 12.0), (2000, 12.0), (2500, 12.0), (3000, 12.0),
    (3250, 12.0), (3500, 4.0), (4000, -200.0), (5000, -200.0),
    (6300, -200.0), (8000, -200.0)])


def _p862_geometry(fs: int):
    """(Nf, Nb, nr_hz, widths, centres, abs_thresh) for 16 k / 8 k.

    Narrowband reuses the wideband construction truncated at 4 kHz (same
    31.25 Hz bins, same modified-bark bands); the final nb band takes the
    remaining 11 bins so the partition covers exactly Nf/2 = 128 bins.
    """
    if fs == 16000:
        return 512, 49, _P862_NR_HZ, _P862_WIDTH_BARK, _P862_CENTRE_BARK, _P862_ABS_THRESH
    if fs == 8000:
        nr = _P862_NR_HZ[:42].copy()
        nr[41] = 128 - int(_P862_NR_HZ[:41].sum())  # = 11
        return (256, 42, nr, _P862_WIDTH_BARK[:42], _P862_CENTRE_BARK[:42],
                _P862_ABS_THRESH[:42])
    raise ValueError(f"PESQ supports fs in (8000, 16000), got {fs}")


def _p862_filter_fd(x: np.ndarray, fs: int, table: np.ndarray) -> np.ndarray:
    """Whole-file frequency-domain filter with a piecewise-linear (Hz, dB)
    gain characteristic (the ITU apply_filter flow)."""
    spec = np.fft.rfft(x)
    f = np.linspace(0, fs / 2.0, len(spec))
    gain_db = np.interp(f, table[:, 0], table[:, 1])
    return np.fft.irfft(spec * 10.0 ** (gain_db / 20.0), n=len(x))


def _p862_fix_level(x: np.ndarray, fs: int) -> np.ndarray:
    """Scale so mean power of the 350-3250 Hz band equals the P.862
    TARGET_AVG_POWER (1e7 in int16-domain units); input absolute scale is
    thereby irrelevant."""
    spec = np.fft.rfft(x)
    f = np.linspace(0, fs / 2.0, len(spec))
    sel = (f >= 350) & (f <= 3250)
    # Parseval: mean band power per sample
    band_pow = 2.0 * np.sum(np.abs(spec[sel]) ** 2) / max(len(x), 1) ** 2
    gain = np.sqrt(_P862_TARGET_POWER / max(band_pow, 1e-30))
    return x * gain


def _p862_butter_hp100(x: np.ndarray, fs: int) -> np.ndarray:
    """P.862.2 wideband input characteristic: 100 Hz high-pass (realized
    as a 2nd-order Butterworth; documented deviation from the reference
    IIR section)."""
    from scipy.signal import butter, lfilter

    b, a = butter(2, 100.0 / (fs / 2.0), btype="highpass")
    return lfilter(b, a, x)


def _p862_pseudo_lp(d: np.ndarray, widths: np.ndarray, p: float) -> np.ndarray:
    """P.862 pseudo-Lp over bands 1..Nb-1 with bark-width weighting:
    totalWidth * (sum((|d|*w)^p) / totalWidth)^(1/p). d is [T, Nb]."""
    h = np.abs(d[:, 1:]) * widths[None, 1:]
    tw = float(widths[1:].sum())
    return tw * (np.sum(h**p, axis=1) / tw) ** (1.0 / p)


def _p862_total_audible(pp: np.ndarray, thresh: np.ndarray, factor: float) -> np.ndarray:
    """Per-frame total power of bands (1..Nb-1) above factor*threshold."""
    a = pp[:, 1:]
    return np.sum(np.where(a > factor * thresh[None, 1:], a, 0.0), axis=1)


def _p862_loudness(pp: np.ndarray, thresh: np.ndarray, centres: np.ndarray) -> np.ndarray:
    """Modified Zwicker loudness density (P.862): exponent raised by
    (6/(centre+2))^0.15 (capped at 2^0.15) below 4 bark; zero below the
    absolute threshold."""
    h = np.where(centres < 4.0, np.minimum(6.0 / (centres + 2.0), 2.0), 1.0)
    mzp = _P862_ZWICKER_POWER * h**0.15  # [Nb]
    t = thresh[None, :]
    loud = (_P862_SL * (t / 0.5) ** mzp[None, :]
            * ((0.5 + 0.5 * pp / t) ** mzp[None, :] - 1.0))
    return np.where(pp > t, np.maximum(loud, 0.0), 0.0)


def _p862_lpq(dframes: np.ndarray, p_syl: float = 6.0, p_time: float = 2.0,
              span: int = 20) -> float:
    """L6 over half-overlapped 20-frame (320 ms) syllables, L2 over
    syllables, uniform time weights; trailing partial syllables divide by
    the full span (implicit zero fill), per the reference aggregation."""
    n = len(dframes)
    step = span // 2
    starts = range(0, n, step)
    vals = []
    for s in starts:
        seg = dframes[s : s + span]
        vals.append((np.sum(seg**p_syl) / span) ** (1.0 / p_syl))
    v = np.asarray(vals)
    return float(np.mean(v**p_time) ** (1.0 / p_time))


def pesq(ref: np.ndarray, deg: np.ndarray, fs: int = 16000, mode: str | None = None) -> float:
    """PESQ MOS-LQO of degraded ``deg`` vs reference ``ref`` per ITU-T
    P.862 (nb, P.862.1 map) / P.862.2 (wb map), using the reference
    implementation's published perceptual-model tables and constants.

    mode "wb" (default for fs=16000) or "nb" (default for fs=8000).
    Identity returns the reference identity anchors (wb 4.644 / nb 4.549).
    See the module docstring for the three documented deviations (global
    time alignment; Butterworth wb input HP; truncation-derived nb
    tables). Matches the reference SE metric flow
    (s3prl/downstream/enhancement_stft/expert.py:38,299,383-385).
    """
    if mode is None:
        mode = "wb" if fs == 16000 else "nb"
    nf, nb, nr_hz, widths, centres, thresh = _p862_geometry(fs)
    ref = np.asarray(ref, np.float64).reshape(-1)
    deg = np.asarray(deg, np.float64).reshape(-1)

    ref = _p862_fix_level(ref - ref.mean(), fs)
    deg = _p862_fix_level(deg - deg.mean(), fs)
    if mode == "wb":
        ref = _p862_butter_hp100(ref, fs)
        deg = _p862_butter_hp100(deg, fs)
    else:
        ref = _p862_filter_fd(ref, fs, _P862_IRS_RECEIVE_DB)
        deg = _p862_filter_fd(deg, fs, _P862_IRS_RECEIVE_DB)
    deg = _time_align(ref, deg, fs)
    n = min(len(ref), len(deg))
    ref, deg = ref[:n], deg[:n]
    if n < 2 * nf:
        return float("nan")

    hop = nf // 2
    w = 0.5 * (1.0 - np.cos(2.0 * np.pi * np.arange(nf) / nf))
    rp = np.abs(np.fft.rfft(_frame(ref, nf, hop) * w, axis=1))[:, : nf // 2] ** 2
    dp = np.abs(np.fft.rfft(_frame(deg, nf, hop) * w, axis=1))[:, : nf // 2] ** 2

    # pitch power densities: per-band bin sums x (100/nr) x Sp
    edges = np.concatenate([[0], np.cumsum(nr_hz)])
    sp = _P862_SP[fs]
    corr = (100.0 / nr_hz) * sp
    rb = np.add.reduceat(rp, edges[:-1], axis=1) * corr[None, :]
    db = np.add.reduceat(dp, edges[:-1], axis=1) * corr[None, :]

    # partial frequency compensation: per-band mean over non-silent frames
    # (+1000 offset, [0.01, 100] clip), applied to the REFERENCE
    silent = _p862_total_audible(rb, thresh, 1e2) < 1e7
    if np.all(silent):
        return float("nan")
    avg_r = rb[~silent].mean(0)
    avg_d = db[~silent].mean(0)
    freq_comp = np.clip((avg_d + 1000.0) / (avg_r + 1000.0), 0.01, 100.0)
    rb_c = rb * freq_comp[None, :]

    # short-term gain compensation: smoothed audible-power ratio
    # (0.2*prev + 0.8*now, clip [3e-4, 5]), applied to the DEGRADED
    pow_r = _p862_total_audible(rb_c, thresh, 1.0)
    pow_d = _p862_total_audible(db, thresh, 1.0)
    ratio = (pow_r + 5.0e3) / (pow_d + 5.0e3)
    gain = np.empty_like(ratio)
    g = 1.0
    for t in range(len(ratio)):
        g = ratio[t] if t == 0 else 0.2 * g + 0.8 * ratio[t]
        gain[t] = np.clip(g, 3.0e-4, 5.0)
    db_c = db * gain[:, None]

    r_loud = _p862_loudness(rb_c, thresh, centres)
    d_loud = _p862_loudness(db_c, thresh, centres)

    # disturbance with the 0.25 masking deadzone
    diff = d_loud - r_loud
    dead = 0.25 * np.minimum(d_loud, r_loud)
    disturbance = np.sign(diff) * np.maximum(np.abs(diff) - dead, 0.0)

    # asymmetry: ((deg+50)/(ref+50))^1.2, zero below 3, capped at 12
    asym = ((db_c + 50.0) / (rb_c + 50.0)) ** 1.2
    asym = np.where(asym < 3.0, 0.0, np.minimum(asym, 12.0))

    d_frame = _p862_pseudo_lp(disturbance, widths, 2.0)
    da_frame = _p862_pseudo_lp(disturbance * asym, widths, 1.0)

    # loud-frame emphasis + the 45 clip
    h = ((pow_r + 1.0e5) / _P862_TARGET_POWER) ** 0.04
    d_frame = np.minimum(d_frame / h, 45.0)
    da_frame = np.minimum(da_frame / h, 45.0)

    d_ind = _p862_lpq(d_frame)
    a_ind = _p862_lpq(da_frame)

    raw = float(np.clip(4.5 - 0.1 * d_ind - 0.0309 * a_ind, -0.5, 4.5))
    if mode == "wb":  # P.862.2 mapping
        return float(0.999 + 4.0 / (1.0 + np.exp(-1.3669 * raw + 3.8224)))
    # P.862.1 mapping (narrowband)
    return float(0.999 + 4.0 / (1.0 + np.exp(-1.4945 * raw + 4.6607)))
