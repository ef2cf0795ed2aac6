"""Griffin-Lim vocoding: log-Mel -> linear spectrogram -> waveform
(counterpart of ``speechain_tpu/ops/griffin_lim.py``).

- :func:`logmel_to_linear` (:37): undo the log, then invert the mel
  filterbank by 30 multiplicative non-negative least-squares steps
  (:func:`nnls_linear`, :69) from the transposed bank, or, with
  ``nnls_iters=0``, by the clamped pseudo-inverse (:func:`mel_pinv`, :30,
  float64 on the host).
- :func:`griffin_lim` (:138): ``n_iter`` alternating inverse STFT / STFT
  phase projections with ``torch.fft`` at the frontend's framing (n_fft
  1102 at 22.05 kHz, which is not a power of two): :func:`stft` (:91)
  reflect-pads and frames, :func:`istft` (:100) overlap-adds the windowed
  frames and divides by the summed squared window.
- :func:`inverse_preemphasis` (:167): the IIR y[t] = x[t] + p y[t-1],
  computed as a log-depth scan of doublings (y[t] += p^s y[t - s] for s =
  1, 2, 4, ...), where the reference runs a sequential scan.
- :func:`logmel_to_wave` (:177): the three in a row, with
  ``wave_len = min(feat_len * hop, L)``.

The initial phases are uniform draws in [0, 1) times 2 pi: the reference
draws them from a JAX key (PRNGKey(0) by default), the port from a CPU
``torch.Generator`` seeded 0 (:func:`draw_phases`), moved to the
spectrogram's device, so that the card and the CPU start from the same
phases. ``phases`` lets a caller pass the draws themselves, for example
the ones JAX drew. No Pallas kernel computes any of this in the reference:
plain PyTorch (``torch.fft``, ``F.fold``) is its counterpart.
"""

from __future__ import annotations

import math
from typing import Optional

import numpy as np
import torch
import torch.nn.functional as F

from speechain_tpu_torch.ops.frontend import (FrontendConfig, hann_window,
                                              mel_filterbank)


def mel_pinv(cfg: FrontendConfig) -> np.ndarray:
    """(n_mels, n_freqs) least-squares inverse of the mel filterbank,
    computed in float64 and rounded to float32."""
    fb = mel_filterbank(cfg.n_freqs, cfg.n_mels, cfg.sr, cfg.fmin, cfg.fmax,
                        cfg.mel_scale, cfg.mel_norm).astype(np.float64)
    return np.linalg.pinv(fb).astype(np.float32)


def _mel_fb(cfg: FrontendConfig, device) -> torch.Tensor:
    return torch.from_numpy(mel_filterbank(
        cfg.n_freqs, cfg.n_mels, cfg.sr, cfg.fmin, cfg.fmax, cfg.mel_scale,
        cfg.mel_norm)).to(device)


def logmel_to_linear(logmel: torch.Tensor, cfg: FrontendConfig,
                     nnls_iters: int = 30) -> torch.Tensor:
    """Invert clamp -> log -> mel: (B, T, n_mels) -> a linear power (or
    magnitude, ``cfg.mag_spec``) spectrogram (B, T, n_freqs), at least
    1e-10. ``nnls_iters`` > 0 refines by non-negative least squares
    (:func:`nnls_linear`); 0 takes the clamped pseudo-inverse."""
    mel = logmel.float()
    if cfg.logging:
        base = cfg.log_base if cfg.log_base is not None else math.e
        mel = torch.exp(mel * math.log(base))
    if nnls_iters <= 0:
        pinv = torch.from_numpy(mel_pinv(cfg)).to(mel.device)
        return torch.clamp(mel @ pinv, min=1e-10)
    return nnls_linear(mel, _mel_fb(cfg, mel.device), nnls_iters)


def nnls_linear(mel: torch.Tensor, fb: torch.Tensor,
                n_iter: int) -> torch.Tensor:
    """min_{p >= 0} ||p fb - mel||^2 by multiplicative updates from p =
    (mel fb^T) / rowsum(fb^2): p (B, T, n_freqs), fb (n_freqs, n_mels),
    mel non-negative; clamped at 1e-10."""
    num = mel @ fb.t()
    p = num / torch.clamp((fb * fb).sum(1), min=1e-10)
    for _ in range(n_iter):
        den = (p @ fb) @ fb.t()
        p = p * num / torch.clamp(den, min=1e-12)
    return torch.clamp(p, min=1e-10)


def padded_window(cfg: FrontendConfig, device) -> torch.Tensor:
    """The periodic Hann window of ``cfg.win`` samples centred in n_fft."""
    w = hann_window(cfg.win)
    n_fft = cfg.fft
    if w.shape[0] < n_fft:
        off = (n_fft - w.shape[0]) // 2
        w = np.pad(w, (off, n_fft - w.shape[0] - off))
    return torch.from_numpy(w).to(device)


def stft(signal: torch.Tensor, window: torch.Tensor, n_fft: int,
         hop: int) -> torch.Tensor:
    """(B, L) -> (B, T, n_fft // 2 + 1) complex: reflect-padded by
    n_fft // 2, framed every ``hop`` samples, windowed, ``rfft``."""
    pad = n_fft // 2
    x = F.pad(signal[:, None], (pad, pad), mode="reflect")[:, 0]
    frames = x.unfold(1, n_fft, hop) * window
    return torch.fft.rfft(frames, n=n_fft, dim=-1)


def istft(spec: torch.Tensor, window: torch.Tensor, n_fft: int, hop: int,
          length: int) -> torch.Tensor:
    """Overlap-add inverse of :func:`stft`: ``irfft`` of each frame times
    the window, summed at its offset, divided by the summed squared window
    (at least 1e-11), then the padding cut: (B, T, F) -> (B, length)."""
    frames = torch.fft.irfft(spec, n=n_fft, dim=-1) * window   # (B, T, N)
    B, T, _ = frames.shape
    pad = n_fft // 2
    out_len = (T - 1) * hop + n_fft

    def ola(x):                                      # (b, T, N) -> (b, L)
        return F.fold(x.transpose(1, 2), (1, out_len), (1, n_fft),
                      stride=(1, hop))[:, 0, 0]

    sig = ola(frames)
    norm = ola((window * window).expand(1, T, n_fft))
    sig = sig / torch.clamp(norm, min=1e-11)
    return sig[:, pad:pad + length]


def draw_phases(shape) -> torch.Tensor:
    """Uniform float32 draws in [0, 1) of ``shape`` on the CPU from a
    generator seeded 0: the default initial phases of :func:`griffin_lim`,
    as fractions of a turn."""
    return torch.rand(tuple(shape),
                      generator=torch.Generator().manual_seed(0))


def griffin_lim(linear: torch.Tensor, cfg: FrontendConfig, n_iter: int = 32,
                length: Optional[int] = None,
                phases: Optional[torch.Tensor] = None) -> torch.Tensor:
    """A linear power (or magnitude) spectrogram (B, T, n_freqs) -> a
    waveform (B, length), length (T - 1) hop by default. The initial
    phases are 2 pi ``phases`` ((B, T, n_freqs) uniform draws), drawn by
    :func:`draw_phases` where none are given."""
    n_fft, hop = cfg.fft, cfg.hop
    window = padded_window(cfg, linear.device)
    linear = linear.float()
    mag = linear if cfg.mag_spec else torch.sqrt(linear)
    B, T, n_freq = mag.shape
    length = length if length is not None else (T - 1) * hop
    if phases is None:
        phases = draw_phases((B, T, n_freq))
    angle = 2 * math.pi * phases.to(mag.device, torch.float32)
    mag_c = mag.to(torch.complex64)
    spec = mag_c * torch.polar(torch.ones_like(angle), angle)
    for _ in range(n_iter):
        wave = istft(spec, window, n_fft, hop, length)
        re = stft(wave, window, n_fft, hop)[:, :T]
        spec = mag_c * (re / torch.clamp(re.abs(), min=1e-16))
    return istft(spec, window, n_fft, hop, length)


def inverse_preemphasis(wave: torch.Tensor, coeff: float) -> torch.Tensor:
    """y[t] = x[t] + coeff y[t - 1] along the last axis (reference
    speech2linear.py:312-333), by doubling: after the step of span s,
    y[t] holds the sum over the last 2 s inputs, and coeff^s underflows
    to 0 long before s reaches the length."""
    y = wave.float()
    L = y.shape[-1]
    s, a = 1, float(coeff)
    while s < L and a != 0.0:
        y = y + a * F.pad(y, (s, 0))[..., :L]
        s, a = 2 * s, a * a
    return y


def logmel_to_wave(logmel: torch.Tensor, feat_len: torch.Tensor,
                   cfg: FrontendConfig, n_iter: int = 32,
                   phases: Optional[torch.Tensor] = None):
    """Denormalized log-Mel (B, T, n_mels) -> (wave (B, (T - 1) hop),
    wave_len = min(feat_len hop, L)): :func:`logmel_to_linear`,
    :func:`griffin_lim`, then :func:`inverse_preemphasis` where the
    frontend pre-emphasizes (reference speech2mel.py:191-210)."""
    linear = logmel_to_linear(logmel, cfg)
    wave = griffin_lim(linear, cfg, n_iter=n_iter, phases=phases)
    if cfg.preemphasis is not None:
        wave = inverse_preemphasis(wave, cfg.preemphasis)
    wave_len = torch.clamp(feat_len.to(torch.int64) * cfg.hop,
                           max=wave.shape[1])
    return wave, wave_len
