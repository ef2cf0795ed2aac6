"""WORLD-style F0 estimation: DIO candidate search + StoneMask refinement.

A copy of ``speechain_tpu/utils/world_pitch.py`` (numpy only, the same
functions, the same results bit for bit), which replaces the reference's
pyworld dependency (utilbox/feat_util.py:256 calls ``pyworld.dio`` +
``pyworld.stonemask``). Implemented in numpy from the published algorithms:

- DIO (Morise et al., "DIO: a fast and reliable F0 estimator", 2009):
  per-octave-band Nuttall low-pass filtering; fundamental-period candidates
  from four event sequences (negative/positive zero-crossings, peaks, dips);
  the per-frame candidate with the smallest inter-event deviation wins;
  unstable frames (frame-to-frame change beyond ``allowed_range``) are
  marked unvoiced.
- StoneMask (Morise, "An instantaneous-frequency-based pitch refinement",
  IEICE 2011): refine each voiced frame by the amplitude-weighted
  instantaneous frequencies of the first harmonics, computed from a
  Blackman-windowed DFT and its derivative window.

The host-side contract matches the reference: hop given in samples or
seconds, f0=0 on unvoiced frames, optional ESPnet-style continuous-F0
linear interpolation (feat_util.py:313-334).
"""

from __future__ import annotations

from typing import Tuple

import numpy as np


def _nuttall(n: int) -> np.ndarray:
    t = np.arange(n) * (2.0 * np.pi / (n - 1))
    return (0.355768 - 0.487396 * np.cos(t) + 0.144232 * np.cos(2 * t)
            - 0.012604 * np.cos(3 * t))


def _lowpass(x: np.ndarray, fs: float, cutoff_hz: float) -> np.ndarray:
    """Zero-phase Nuttall-kernel low-pass via FFT convolution. The kernel is
    a Nuttall window spanning two fundamental periods of the cutoff — the
    DIO band filter."""
    half = max(int(round(fs / cutoff_hz)), 2)
    kernel = _nuttall(2 * half + 1)
    kernel = kernel / kernel.sum()
    n = len(x) + len(kernel)
    nfft = 1 << int(np.ceil(np.log2(n)))
    y = np.fft.irfft(np.fft.rfft(x, nfft) * np.fft.rfft(kernel, nfft), nfft)
    return y[half:half + len(x)]


def _event_intervals(sig: np.ndarray, fs: float, negative: bool
                     ) -> Tuple[np.ndarray, np.ndarray]:
    """Zero-crossing event times and interval-based F0 estimates.

    negative=True: downward crossings; False: upward. Sub-sample positions
    by linear interpolation.
    """
    s = sig if negative else -sig
    idx = np.where((s[:-1] > 0) & (s[1:] <= 0))[0]
    if len(idx) < 2:
        return np.zeros(0), np.zeros(0)
    frac = s[idx] / (s[idx] - s[idx + 1])
    times = (idx + frac) / fs
    intervals = np.diff(times)
    centers = (times[:-1] + times[1:]) / 2
    good = intervals > 0
    return centers[good], 1.0 / intervals[good]


def _four_event_candidates(band: np.ndarray, fs: float,
                           positions: np.ndarray
                           ) -> Tuple[np.ndarray, np.ndarray]:
    """Per-frame candidate F0 and deviation from the four event sequences."""
    diff = np.empty_like(band)
    diff[:-1] = band[1:] - band[:-1]
    diff[-1] = 0.0
    sets = [
        _event_intervals(band, fs, negative=True),
        _event_intervals(band, fs, negative=False),
        _event_intervals(diff, fs, negative=True),    # peaks
        _event_intervals(diff, fs, negative=False),   # dips
    ]
    est = np.zeros((4, len(positions)))
    usable = np.ones(len(positions), bool)
    for k, (t, f) in enumerate(sets):
        if len(t) < 2:
            usable[:] = False
            break
        est[k] = np.interp(positions, t, f)
        usable &= (positions >= t[0]) & (positions <= t[-1])
    f0_cand = est.mean(axis=0)
    dev = np.sqrt(np.maximum(
        ((est - f0_cand) ** 2).sum(axis=0) / 3.0, 1e-12))
    score = dev / np.maximum(f0_cand, 1e-12)
    f0_cand = np.where(usable, f0_cand, 0.0)
    score = np.where(usable, score, np.inf)
    return f0_cand, score


def dio(x: np.ndarray, fs: int, *, f0_floor: float = 80.0,
        f0_ceil: float = 400.0, frame_period: float = 10.0,
        channels_in_octave: float = 2.0, allowed_range: float = 0.1
        ) -> Tuple[np.ndarray, np.ndarray]:
    """DIO F0 track. Returns (temporal_positions [s], f0 [Hz], 0=unvoiced).

    frame_period is in milliseconds like pyworld.dio.
    """
    x = np.asarray(x, np.float64).reshape(-1)
    x = x - x.mean() if len(x) else x
    n_frames = int(len(x) / fs * 1000.0 / frame_period) + 1
    positions = np.arange(n_frames) * frame_period / 1000.0

    n_bands = int(np.ceil(np.log2(f0_ceil / f0_floor)
                          * channels_in_octave)) + 1
    boundary_f0s = f0_floor * 2.0 ** (
        (np.arange(n_bands) + 1) / channels_in_octave)

    best_f0 = np.zeros(n_frames)
    best_score = np.full(n_frames, np.inf)
    for b0 in boundary_f0s:
        band = _lowpass(x, fs, b0)
        cand, score = _four_event_candidates(band, fs, positions)
        # a band only proposes candidates near its own octave
        ok = (cand >= max(b0 / 2.0, f0_floor)) & \
             (cand <= min(b0 * 2.0, f0_ceil)) & (score < best_score)
        best_f0 = np.where(ok, cand, best_f0)
        best_score = np.where(ok, score, best_score)

    # voicing: deviation threshold + temporal stability (allowed_range per
    # frame step, DIO's FixStep1)
    voiced = (best_f0 > 0) & (best_score < allowed_range)
    f0 = np.where(voiced, best_f0, 0.0)
    prev = f0[:-1]
    cur = f0[1:]
    jump = np.abs(cur - prev) / np.maximum(cur, 1e-12)
    bad = (prev > 0) & (cur > 0) & (jump > allowed_range)
    # kill isolated one-frame jumps rather than whole segments
    f0[1:] = np.where(bad & np.concatenate([bad[1:], [False]]), 0.0, cur)

    # remove very short voiced segments (DIO's FixStep2, segments < 3
    # frames are unreliable)
    v = f0 > 0
    start = None
    for i in range(n_frames + 1):
        on = i < n_frames and v[i]
        if on and start is None:
            start = i
        elif not on and start is not None:
            if i - start < 3:
                f0[start:i] = 0.0
            start = None
    return positions, f0


def stonemask(x: np.ndarray, fs: int, temporal_positions: np.ndarray,
              f0: np.ndarray) -> np.ndarray:
    """Refine a DIO F0 track with instantaneous frequencies (StoneMask)."""
    x = np.asarray(x, np.float64).reshape(-1)
    refined = f0.copy()
    for i, (t, f) in enumerate(zip(temporal_positions, f0)):
        if f <= 0:
            continue
        f1 = _refine_one(x, fs, t, f)
        if f1 > 0:
            f2 = _refine_one(x, fs, t, f1)   # second pass like stonemask
            refined[i] = f2 if f2 > 0 else f1
    return refined


def _refine_one(x: np.ndarray, fs: int, t: float, f0_initial: float) -> float:
    half_window = int(1.5 * fs / f0_initial + 0.5)
    center = int(t * fs + 0.5)
    lo = center - half_window
    hi = center + half_window + 1
    if lo < 0 or hi > len(x) or half_window < 2:
        return f0_initial
    seg = x[lo:hi]
    n = len(seg)
    # Blackman main window + derivative window (StoneMask's diff window)
    w = np.blackman(n)
    main = seg * w
    dw = np.zeros(n)
    dw[1:-1] = -(w[2:] - w[:-2]) / 2.0
    diffseg = seg * dw

    nfft = 1 << int(np.ceil(np.log2(n))) + 1
    S = np.fft.rfft(main, nfft)
    D = np.fft.rfft(diffseg, nfft)
    power = (S.real ** 2 + S.imag ** 2)
    # instantaneous frequency: bin frequency + phase-derivative correction
    numerator = S.real * D.imag - S.imag * D.real
    freq_axis = np.arange(len(S)) * fs / nfft
    inst = freq_axis + numerator / np.maximum(power, 1e-30) * fs / (2 * np.pi)

    n_harm = int(min(np.floor(fs / 2.0 / f0_initial), 6))
    if n_harm < 1:
        return f0_initial
    num = 0.0
    den = 0.0
    for k in range(1, n_harm + 1):
        j = int(round(f0_initial * k * nfft / fs))
        if j >= len(S):
            break
        amp = np.sqrt(power[j])
        num += amp * inst[j]
        den += amp * k
    if den <= 0:
        return f0_initial
    refined = num / den
    if refined < f0_initial * 0.5 or refined > f0_initial * 2.0:
        return f0_initial
    return float(refined)


def continuous_f0(f0: np.ndarray) -> np.ndarray:
    """ESPnet-style continuous F0 (feat_util.py:313-334): extend first/last
    voiced values to the edges, linearly interpolate the unvoiced gaps."""
    f0 = f0.copy()
    nz = np.nonzero(f0)[0]
    if len(nz) == 0:
        return f0
    f0[:nz[0]] = f0[nz[0]]
    f0[nz[-1]:] = f0[nz[-1]]
    nz = np.nonzero(f0)[0]
    zeros = np.where(f0 == 0)[0]
    if len(zeros):
        f0[zeros] = np.interp(zeros, nz, f0[nz])
    return f0


def convert_wav_to_pitch(wav: np.ndarray, *, hop_length=256, sr: int = 22050,
                         f0min: float = 80.0, f0max: float = 400.0,
                         do_continuous_f0: bool = True) -> np.ndarray:
    """Drop-in analog of the reference convert_wav_to_pitch
    (utilbox/feat_util.py:256-339): dio -> stonemask -> optional
    continuous-F0 interpolation. hop_length: samples (int) or seconds
    (float)."""
    if isinstance(hop_length, float):
        hop_length = int(hop_length * sr)
    wav = np.asarray(wav, np.float64).reshape(-1)
    frame_period = 1000.0 * hop_length / sr
    pos, f0 = dio(wav, sr, f0_floor=f0min, f0_ceil=f0max,
                  frame_period=frame_period)
    f0 = stonemask(wav, sr, pos, f0)
    if do_continuous_f0:
        f0 = continuous_f0(f0)
    return f0.astype(np.float32)
