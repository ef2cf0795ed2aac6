"""On-the-fly acoustic frontend: waveform -> (log-)Mel spectrogram.

Counterpart of ``speechain_tpu/ops/frontend.py``. The filterbank functions
and :class:`FrontendConfig` are copies (numpy, float64 -> float32), so both
packages use bit-identical constants. :func:`frontend_impl` is the plain
PyTorch pipeline (pre-emphasis -> reflect centre-pad -> framing -> windowed
DFT -> power -> slaney mel -> clamp -> log); :func:`compute_logmel` sends
the log-Mel case to the fused CUDA kernel (``ops/cuda_logmel.py``) for a
tensor on the card.

Numerical contract (``docs/ARCHITECTURE.md``): max abs error of log-Mel
< 1e-4 in float32. TF32 would break it, so callers on the card set
``torch.backends.cuda.matmul.allow_tf32 = False`` and
``torch.backends.cudnn.allow_tf32 = False``
(:func:`speechain_tpu_torch.utils.device.set_fp32_matmul_exact`).
"""

from __future__ import annotations

import dataclasses
import functools
import math
from typing import Optional

import numpy as np
import torch
import torch.nn.functional as F


# --------------------------------------------------------------------------
# host-side constant construction (numpy, float64 -> float32)
# --------------------------------------------------------------------------

def hz_to_mel(freq, mel_scale: str = "slaney"):
    freq = np.asarray(freq, dtype=np.float64)
    if mel_scale == "htk":
        return 2595.0 * np.log10(1.0 + freq / 700.0)
    # slaney: linear below 1 kHz, log above
    f_sp = 200.0 / 3.0
    mels = freq / f_sp
    min_log_hz = 1000.0
    min_log_mel = min_log_hz / f_sp
    logstep = math.log(6.4) / 27.0
    return np.where(freq >= min_log_hz,
                    min_log_mel + np.log(np.maximum(freq, min_log_hz) / min_log_hz) / logstep,
                    mels)


def mel_to_hz(mels, mel_scale: str = "slaney"):
    mels = np.asarray(mels, dtype=np.float64)
    if mel_scale == "htk":
        return 700.0 * (10.0 ** (mels / 2595.0) - 1.0)
    f_sp = 200.0 / 3.0
    freqs = f_sp * mels
    min_log_hz = 1000.0
    min_log_mel = min_log_hz / f_sp
    logstep = math.log(6.4) / 27.0
    return np.where(mels >= min_log_mel,
                    min_log_hz * np.exp(logstep * (mels - min_log_mel)),
                    freqs)


def mel_filterbank(n_freqs: int, n_mels: int, sample_rate: int,
                   f_min: float = 0.0, f_max: Optional[float] = None,
                   mel_scale: str = "slaney", norm: bool = True) -> np.ndarray:
    """Triangular mel filter bank, shape (n_freqs, n_mels).

    Matches torchaudio.functional.melscale_fbanks (linear2mel.py:135-143).
    """
    f_max = float(f_max) if f_max is not None else sample_rate / 2.0
    all_freqs = np.linspace(0.0, sample_rate // 2, n_freqs)
    m_min, m_max = hz_to_mel(f_min, mel_scale), hz_to_mel(f_max, mel_scale)
    m_pts = np.linspace(float(m_min), float(m_max), n_mels + 2)
    f_pts = mel_to_hz(m_pts, mel_scale)
    # triangles
    f_diff = f_pts[1:] - f_pts[:-1]                       # (n_mels+1,)
    slopes = f_pts[None, :] - all_freqs[:, None]          # (n_freqs, n_mels+2)
    down = -slopes[:, :-2] / f_diff[:-1]
    up = slopes[:, 2:] / f_diff[1:]
    fb = np.maximum(0.0, np.minimum(down, up))
    if norm:  # slaney area normalization
        enorm = 2.0 / (f_pts[2: n_mels + 2] - f_pts[:n_mels])
        fb = fb * enorm[None, :]
    return fb.astype(np.float32)


def hann_window(win_length: int) -> np.ndarray:
    """Periodic Hann window (torch.hann_window default)."""
    n = np.arange(win_length, dtype=np.float64)
    return (0.5 - 0.5 * np.cos(2.0 * np.pi * n / win_length)).astype(np.float32)


def dft_filterbank(n_fft: int, window: np.ndarray, onesided: bool = True,
                   normalized: bool = False) -> np.ndarray:
    """Windowed DFT basis as a conv filter bank: (2*n_freq, n_fft).

    Row k (< n_freq) is w[n]*cos(2 pi k n / n_fft); row n_freq+k the -sin
    counterpart, so conv output channels are (real, imag) interleaved halves.
    """
    n_freq = n_fft // 2 + 1 if onesided else n_fft
    n = np.arange(n_fft, dtype=np.float64)
    k = np.arange(n_freq, dtype=np.float64)[:, None]
    ang = 2.0 * np.pi * k * n[None, :] / n_fft
    win = np.zeros(n_fft, dtype=np.float64)
    # center a shorter window inside n_fft (torch.stft semantics)
    off = (n_fft - len(window)) // 2
    win[off: off + len(window)] = window.astype(np.float64)
    basis = np.concatenate([np.cos(ang), -np.sin(ang)], axis=0) * win[None, :]
    if normalized:
        basis = basis / math.sqrt(np.sum(win ** 2))
    return basis.astype(np.float32)


# --------------------------------------------------------------------------
# config
# --------------------------------------------------------------------------

@dataclasses.dataclass(frozen=True)
class FrontendConfig:
    """Config for the waveform->log-Mel pipeline (speech2mel.py:24-47 surface)."""
    n_mels: int = 80
    hop_length: float = 0.01       # int samples or float seconds
    win_length: float = 0.025
    n_fft: Optional[int] = None
    sr: int = 16000
    preemphasis: Optional[float] = None
    pre_stft_norm: Optional[str] = None
    center: bool = True
    normalized: bool = False
    onesided: bool = True
    mag_spec: bool = False
    return_energy: bool = False
    fmin: float = 0.0
    fmax: Optional[float] = None
    clamp: float = 1e-10
    logging: bool = True
    log_base: Optional[float] = 10.0
    mel_scale: str = "slaney"
    mel_norm: bool = True
    # kept for config compatibility with the JAX package, where it picks
    # the TPU matrix unit's pass count; the port's products are always
    # full float32
    matmul_precision: str = "highest"

    def __post_init__(self):
        if self.fmax is not None and self.fmax > self.sr / 2:
            import warnings
            warnings.warn(
                f"frontend fmax={self.fmax} exceeds Nyquist ({self.sr / 2}):"
                f" mel filters above Nyquist are empty; set fmax <= sr/2",
                stacklevel=2)

    @property
    def hop(self) -> int:
        return int(self.hop_length * self.sr) if isinstance(self.hop_length, float) else int(self.hop_length)

    @property
    def win(self) -> int:
        return int(self.win_length * self.sr) if isinstance(self.win_length, float) else int(self.win_length)

    @property
    def fft(self) -> int:
        return int(self.n_fft) if self.n_fft is not None else self.win

    @property
    def n_freqs(self) -> int:
        return self.fft // 2 + 1 if self.onesided else self.fft

    @property
    def output_size(self) -> int:
        return self.n_mels


@functools.lru_cache(maxsize=16)
def frontend_constants(cfg: FrontendConfig, device: torch.device):
    """(basis (n_fft, 2*n_freq), mel_fb (n_freq, n_mels)) float32 on
    ``device``; built once per (config, device)."""
    basis = dft_filterbank(cfg.fft, hann_window(cfg.win), cfg.onesided,
                           cfg.normalized)
    mel_fb = mel_filterbank(cfg.n_freqs, cfg.n_mels, cfg.sr, cfg.fmin,
                            cfg.fmax, cfg.mel_scale, cfg.mel_norm)
    return (torch.from_numpy(np.ascontiguousarray(basis.T)).to(device),
            torch.from_numpy(mel_fb).to(device))


def dft_folds(cfg: FrontendConfig) -> bool:
    """Whether the log-Mel kernel folds the DFT for ``cfg``: n_fft even and
    the window centred in it (n_fft - win even, win <= n_fft). The padded
    Hann window is then symmetric about n_fft / 2 and 0 at n = 0."""
    n_fft, win = cfg.fft, cfg.win
    return n_fft % 2 == 0 and win <= n_fft and (n_fft - win) % 2 == 0


def folded_dft_basis(cfg: FrontendConfig) -> np.ndarray:
    """The DFT basis rows the log-Mel kernel sums over, (rows, 2, n_freq)
    float32: [r, 0] the cos half and [r, 1] the -sin half of
    :func:`dft_filterbank`'s row n, bit for bit. Folded (:func:`dft_folds`)
    the rows are n = 1 .. n_fft / 2, against e[n] = x[n] + x[N - n] and
    o[n] = x[n] - x[N - n] (row 0 is 0: the window is); direct, every n."""
    basis = dft_filterbank(cfg.fft, hann_window(cfg.win), cfg.onesided,
                           cfg.normalized)                  # (2F, n_fft)
    F = cfg.n_freqs
    pair = np.stack([basis[:F].T, basis[F:].T], axis=1)     # (n_fft, 2, F)
    if not dft_folds(cfg):
        return np.ascontiguousarray(pair)
    if np.any(pair[0] != 0.0):
        raise ValueError("the folded DFT needs a window that is 0 at n = 0")
    return np.ascontiguousarray(pair[1:cfg.fft // 2 + 1])


def mel_bands(mel_fb: np.ndarray):
    """Each mel filter's band of ``mel_fb`` (n_freq, n_mels): (lo, hi)
    int32 (n_mels,), from its first to one past its last non-zero bin
    (lo = hi = 0 for an empty filter)."""
    nz = mel_fb != 0
    any_ = nz.any(axis=0)
    lo = np.where(any_, nz.argmax(axis=0), 0)
    hi = np.where(any_, mel_fb.shape[0] - nz[::-1].argmax(axis=0), 0)
    return lo.astype(np.int32), hi.astype(np.int32)


# --------------------------------------------------------------------------
# pipeline
# --------------------------------------------------------------------------

def num_frames(wave_len, n_fft: int, hop: int, center: bool):
    eff = wave_len + (2 * (n_fft // 2) if center else 0)
    return (eff - n_fft) // hop + 1


def to_float_wave(wave: torch.Tensor) -> torch.Tensor:
    """Accept int16 PCM directly: int16 -> float32 * 2^-15 is exact, so the
    result is bit-identical to converting on the host."""
    if not torch.is_floating_point(wave):
        if wave.dtype != torch.int16:
            raise TypeError(
                f"integer waveforms must be int16 PCM, got {wave.dtype}")
        return wave.to(torch.float32) * (1.0 / 32768.0)
    return wave.to(torch.float32)


def preemphasize(wave: torch.Tensor, wave_len: torch.Tensor,
                 coeff: float) -> torch.Tensor:
    """y[t] = x[t] - p*x[t-1], y[0] = x[0], zero at t >= wave_len."""
    prev = F.pad(wave, (1, 0))[:, :-1]
    wave = wave - coeff * prev
    pos = torch.arange(wave.shape[1], device=wave.device)
    return torch.where(pos[None, :] < wave_len[:, None], wave,
                       torch.zeros((), dtype=wave.dtype, device=wave.device))


def frontend_impl(wave: torch.Tensor, wave_len: torch.Tensor,
                  cfg: FrontendConfig, mel_fb: Optional[torch.Tensor] = None):
    """wave (B, L) float or int16 PCM -> (feat (B, T, n_mels), feat_len,
    energy, energy_len). Plain PyTorch; the reference's XLA pipeline.
    ``mel_fb`` (n_freq, M) replaces the config's mel bank (the linear
    spectrogram's identity)."""
    wave = to_float_wave(wave)
    wave_len = wave_len.to(torch.int32)
    n_fft, hop = cfg.fft, cfg.hop
    n_freq = cfg.n_freqs
    basis, cfg_mel_fb = frontend_constants(cfg, wave.device)
    if mel_fb is None:
        mel_fb = cfg_mel_fb

    if cfg.preemphasis is not None:
        wave = preemphasize(wave, wave_len, cfg.preemphasis)

    if cfg.pre_stft_norm == "mean_std":
        mean = wave.mean(dim=1, keepdim=True)
        std = wave.std(dim=1, keepdim=True, correction=0)
        wave = (wave - mean) / std
    elif cfg.pre_stft_norm == "min_max":
        lo = wave.amin(dim=1, keepdim=True)
        hi = wave.amax(dim=1, keepdim=True)
        wave = (wave - lo) / (hi - lo) * 2.0 - 1.0

    if cfg.center:
        pad = n_fft // 2
        wave = F.pad(wave[:, None, :], (pad, pad), mode="reflect")[:, 0]
    frames = wave.unfold(1, n_fft, hop)                    # (B, T, n_fft)
    spec = frames @ basis                                  # (B, T, 2F)
    re, im = spec[..., :n_freq], spec[..., n_freq:]
    power = re * re + im * im
    T = power.shape[1]

    feat_len = num_frames(wave_len, n_fft, hop, cfg.center).to(torch.int32)
    valid = (torch.arange(T, device=wave.device)[None, :, None]
             < feat_len[:, None, None])
    zero = torch.zeros((), dtype=power.dtype, device=power.device)

    energy = None
    if cfg.return_energy:
        energy = torch.sqrt(torch.clamp(power.sum(-1), min=1e-10))
        energy = torch.where(valid[:, :, 0], energy, zero)

    power = torch.where(valid, power, zero)
    if cfg.mag_spec:
        power = torch.sqrt(power)

    feat = power @ mel_fb
    if cfg.logging:
        feat = torch.log(torch.clamp(feat, min=cfg.clamp))
        if cfg.log_base is not None:
            feat = feat / math.log(cfg.log_base)
    feat = torch.where(valid, feat, zero)
    return feat, feat_len, energy, feat_len if cfg.return_energy else None


def compute_logmel(wave: torch.Tensor, wave_len: torch.Tensor,
                   cfg: FrontendConfig, *, use_kernel: Optional[bool] = None):
    """Dispatch between the plain pipeline and the fused log-Mel kernel.

    The kernel gives no energy output and applies no pre-STFT norm, so those
    configurations take :func:`frontend_impl`. Default: the kernel's
    wrapper, which runs the kernel for a CUDA tensor and its plain version
    for a CPU tensor."""
    if use_kernel is None:
        use_kernel = not cfg.return_energy and cfg.pre_stft_norm is None
    wave = to_float_wave(wave)
    if use_kernel:
        from speechain_tpu_torch.ops.cuda_logmel import cuda_logmel
        feat, feat_len = cuda_logmel(wave, wave_len, cfg)
        return feat, feat_len, None, None
    return frontend_impl(wave, wave_len, cfg)


class LogMelFrontend:
    """Callable frontend, the counterpart of the JAX package's
    ``LogMelFrontend`` (``speechain_tpu/ops/frontend.py:329``)::

        fe = LogMelFrontend(FrontendConfig(n_mels=80, preemphasis=0.97))
        feat, feat_len = fe(wave, wave_len)

    ``__call__`` goes through :func:`compute_logmel`, so a CUDA batch runs
    the log-Mel kernel wherever that dispatch takes it, and an energy or
    pre-STFT-norm config the plain pipeline. (The reference's class always
    runs its plain pipeline; the kernel is within 1e-4 of it.) The
    banks are built once per (config, device) by
    :func:`frontend_constants`."""

    def __init__(self, cfg: FrontendConfig = None, **kwargs):
        if cfg is None:
            cfg = FrontendConfig(**kwargs)
        self.cfg = cfg

    @property
    def output_size(self) -> int:
        return self.cfg.output_size

    def __call__(self, wave: torch.Tensor, wave_len: torch.Tensor):
        feat, feat_len, energy, energy_len = compute_logmel(
            wave, wave_len, self.cfg)
        if self.cfg.return_energy:
            return feat, feat_len, energy, energy_len
        return feat, feat_len

    def linear_spectrogram(self, wave: torch.Tensor, wave_len: torch.Tensor):
        """Power (or magnitude) linear spectrogram, (B, T, n_freqs): the
        plain pipeline with an identity mel bank and no log."""
        lin_cfg = dataclasses.replace(self.cfg, logging=False)
        ident = torch.eye(self.cfg.n_freqs, dtype=torch.float32,
                          device=wave.device)
        feat, feat_len, _, _ = frontend_impl(wave, wave_len, lin_cfg, ident)
        return feat, feat_len

    def num_frames(self, wave_len):
        return num_frames(wave_len, self.cfg.fft, self.cfg.hop,
                          self.cfg.center)
