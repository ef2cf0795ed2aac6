"""TTS objective evaluation: MCD / MSD / log-F0 RMSE with DTW alignment.

Counterpart of ``speechain_tpu/utils/tts_eval.py``:
- log-Mel from the port's :class:`LogMelFrontend` (the log-Mel kernel on
  the card, its plain version on the CPU), 50 ms windows, 12.5 ms hops;
- MFCC = DCT-II over the log-Mel;
- DTW = exact O(T1 T2) dynamic programming over Euclidean frame
  distances, with the reference's tie-breaking;
- F0 from the WORLD-style tracker (``utils/world_pitch.py``);
- MCD / MSD = (10 / ln 10) sqrt(2) x the mean aligned frame distance.
Everything after the features is numpy, as in the reference.

:func:`dtw_path` fills the accumulated-cost matrix one anti-diagonal at a
time (each cell needs only the two diagonals before it): the same
additions and minima as the reference's cell-by-cell loop, so the same
matrix and path bit for bit, in O(T1 + T2) numpy steps.
"""

from __future__ import annotations

from typing import Optional, Tuple

import numpy as np
import torch

from speechain_tpu_torch.ops.frontend import FrontendConfig, LogMelFrontend
from speechain_tpu_torch.utils import world_pitch
from speechain_tpu_torch.utils.device import (resolve_device,
                                              set_fp32_matmul_exact)


def wav_to_logmel(wave: np.ndarray, sr: int, n_mels: int = 80,
                  win_length: float = 0.05, hop_length: float = 0.0125,
                  device=None) -> np.ndarray:
    """(T, n_mels) float32 log10-Mel of one waveform, computed on
    ``device`` (the card unless ``"cpu"``)."""
    dev = resolve_device(device)
    if dev.type == "cuda":
        set_fp32_matmul_exact()
    fe = LogMelFrontend(FrontendConfig(n_mels=n_mels, sr=sr,
                                       win_length=win_length,
                                       hop_length=hop_length))
    wave = torch.from_numpy(np.asarray(wave, np.float32).reshape(1, -1))
    feat, feat_len = fe(wave.to(dev), torch.tensor([wave.shape[1]],
                                                   device=dev))
    return feat[0, : int(feat_len[0])].cpu().numpy()


def wav_to_mfcc(wave: np.ndarray, sr: int, n_mfcc: int = 13,
                win_length: float = 0.05, hop_length: float = 0.0125,
                device=None) -> np.ndarray:
    """MFCC, (T, n_mfcc): DCT-II (orthonormal) of 10 x the log10-Mel."""
    logmel = wav_to_logmel(wave, sr, 80, win_length, hop_length, device)
    db = 10.0 * logmel
    M = db.shape[1]
    n = np.arange(M)
    dct = np.cos(np.pi / M * (n[None, :] + 0.5) * np.arange(n_mfcc)[:, None])
    dct *= np.sqrt(2.0 / M)
    dct[0] /= np.sqrt(2.0)
    return db @ dct.T                                       # (T, n_mfcc)


def wav_to_pitch(wave: np.ndarray, sr: int, hop_length: float = 0.0125,
                 fmin: float = 60.0, fmax: float = 400.0,
                 voicing_threshold: float = 0.3) -> np.ndarray:
    """Autocorrelation F0 with parabolic interpolation; 0 = unvoiced."""
    hop = int(hop_length * sr)
    win = int(0.05 * sr)
    lag_min = int(sr / fmax)
    lag_max = min(int(sr / fmin), win - 1)
    n_frames = max(0, (len(wave) - win) // hop + 1)
    f0 = np.zeros(n_frames)
    for i in range(n_frames):
        frame = wave[i * hop: i * hop + win].astype(np.float64)
        frame = frame - frame.mean()
        energy = (frame ** 2).sum()
        if energy < 1e-8:
            continue
        ac = np.correlate(frame, frame, mode="full")[win - 1:]
        ac = ac / ac[0]
        seg = ac[lag_min:lag_max]
        if len(seg) == 0:
            continue
        peak = int(np.argmax(seg)) + lag_min
        if ac[peak] < voicing_threshold:
            continue
        if 0 < peak < len(ac) - 1:                  # parabolic refinement
            a, b, c = ac[peak - 1], ac[peak], ac[peak + 1]
            denom = a - 2 * b + c
            shift = 0.5 * (a - c) / denom if abs(denom) > 1e-12 else 0.0
            peak = peak + shift
        f0[i] = sr / peak
    return f0


def dtw_path(a: np.ndarray, b: np.ndarray) -> Tuple[np.ndarray, np.ndarray]:
    """Exact DTW over Euclidean frame distances of (T1, D) / (T2, D)
    features (or 1-D tracks); returns the aligned index arrays (path_a,
    path_b). Ties in the backtrace go to the smallest (cost, i, j)."""
    a2 = (a ** 2).sum(-1)[:, None] if a.ndim == 2 else (a ** 2)[:, None]
    b2 = (b ** 2).sum(-1)[None, :] if b.ndim == 2 else (b ** 2)[None, :]
    ab = a @ b.T if a.ndim == 2 else a[:, None] * b[None, :]
    dist = np.sqrt(np.maximum(a2 + b2 - 2 * ab, 0.0))
    T1, T2 = dist.shape
    acc = np.full((T1 + 1, T2 + 1), np.inf)
    acc[0, 0] = 0.0
    for d in range(2, T1 + T2 + 1):              # cells with i + j = d
        i = np.arange(max(1, d - T2), min(T1, d - 1) + 1)
        j = d - i
        acc[i, j] = dist[i - 1, j - 1] + np.minimum(
            np.minimum(acc[i - 1, j - 1], acc[i - 1, j]), acc[i, j - 1])
    i, j = T1, T2
    pa, pb = [], []
    while i > 0 and j > 0:
        pa.append(i - 1)
        pb.append(j - 1)
        moves = [(acc[i - 1, j - 1], i - 1, j - 1),
                 (acc[i - 1, j], i - 1, j),
                 (acc[i, j - 1], i, j - 1)]
        _, i, j = min(moves)
    pa.reverse()
    pb.reverse()
    return np.asarray(pa), np.asarray(pb)


MCD_COEFF = 10.0 / np.log(10.0) * np.sqrt(2.0)


def _too_short(*waves, sr) -> bool:
    # below one analysis window no frame exists (an untrained FastSpeech2
    # may predict zero durations): the caller records the utterance as
    # unscoreable
    return any(len(np.reshape(w, -1)) < int(0.05 * sr) for w in waves)


def _aligned_distance(h: np.ndarray, r: np.ndarray) -> float:
    pa, pb = dtw_path(h, r)
    return float(MCD_COEFF * np.mean(
        np.sqrt(((h[pa] - r[pb]) ** 2).sum(-1))))


def mcd(hypo_wave: np.ndarray, refer_wave: np.ndarray, sr: int,
        device=None) -> Optional[float]:
    """Mel-cepstral distortion over DTW-aligned MFCC frames; None if
    either wave is too short."""
    if _too_short(hypo_wave, refer_wave, sr=sr):
        return None
    return _aligned_distance(wav_to_mfcc(hypo_wave, sr, device=device),
                             wav_to_mfcc(refer_wave, sr, device=device))


def msd(hypo_wave: np.ndarray, refer_wave: np.ndarray, sr: int,
        device=None) -> Optional[float]:
    """Mel-spectral distortion over DTW-aligned log-Mels; None if either
    wave is too short."""
    if _too_short(hypo_wave, refer_wave, sr=sr):
        return None
    return _aligned_distance(wav_to_logmel(hypo_wave, sr, device=device),
                             wav_to_logmel(refer_wave, sr, device=device))


def log_f0_rmse(hypo_wave: np.ndarray, refer_wave: np.ndarray, sr: int
                ) -> Optional[float]:
    """RMSE of log-F0 over the DTW-aligned frames voiced in both tracks
    (hop 256 samples, no continuous-F0 interpolation), on the host; None
    if either wave is too short or no frame is voiced in both."""
    if _too_short(hypo_wave, refer_wave, sr=sr):
        return None
    h = world_pitch.convert_wav_to_pitch(hypo_wave, hop_length=256, sr=sr,
                                         do_continuous_f0=False)
    r = world_pitch.convert_wav_to_pitch(refer_wave, hop_length=256, sr=sr,
                                         do_continuous_f0=False)
    pa, pb = dtw_path(h, r)
    h, r = h[pa], r[pb]
    voiced = (h > 0) & (r > 0)
    if voiced.sum() == 0:
        return None
    rmse = float(np.sqrt(np.mean(
        (np.log(h[voiced]) - np.log(r[voiced])) ** 2)))
    return None if np.isnan(rmse) else rmse
