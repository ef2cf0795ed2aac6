"""Fused waveform -> log-Mel CUDA kernel (``csrc/logmel.cu``).

Replaces ``speechain_tpu/ops/pallas_logmel.py::pallas_logmel`` (the
``pl.pallas_call`` at :110, body ``_logmel_kernel`` :38): framing, window,
DFT, power, mel product and clamp/log, with the spectrum kept on chip.

On the H100 the work is float32 arithmetic. At conformer-small's batch
(16 x 8 s: 12,816 frames of n_fft 400, 201 bins, 80 mels) the direct DFT
is 4.12 GFLOP (0.068 ms at 67 TFLOP/s); folded about the window's centre
(``frontend.dft_folds``) it is half: 12,816 x (80,400 multiply-adds, 398
fold adds, 603 power and <= 804 mel operations) = 2.08 GFLOP, 0.031 ms,
against 13 MB of waveform and features (0.004 ms at 3.35 TB/s). TF32
breaks the < 1e-4 contract, so the kernel runs on the FMA units and
feeds them: a block of 8 warps owns TT = 8 TF frames of one utterance
(TF frames a warp, a template argument), stages the waveform samples they
read once, and each thread keeps TF frames x 7 bins of re and im in
registers while the basis streams through a cp.async ring in chunks of KC
rows; 8 shared loads feed 14 TF multiply-adds. Folded, bins 0 .. TB - 1
are summed once more beside the folded products by the direct DFT in the
plain version's row order, LR rows a chunk (:func:`low_basis`, where a
mel filter weighs them: :func:`band_counts`):
pre-emphasis leaves them so little power that the fold's float32 rounding
alone moved mel bin 0 by 2.4e-4 from the plain version in 16 x 8 s of
noise (PERF.md).

:func:`geometry` picks TF from the built instances whose shared memory
fits, by the cycles :func:`_cycles` reckons (the larger tile on a tie):
the busiest SM's blocks, each row bound by its FMAs or, below TF 5, by
its shared-memory wavefronts, or the basis the blocks read from L2. At
the path's 16 x 801 frames on 132 SMs that is TF 7: 240 blocks of 56
frames, two on the busiest SMs (112 frames against an even 97.1); TTS's
16 x 641 frames take TF 6. TF 8 (243 registers) is not built: on the
card it lost to TF 7 at the ASR shape by 10 % and won at the direct-DFT
config by 8 %, a margin the reckoning cannot tell (PERF.md).
"""

from __future__ import annotations

import ctypes
import functools
import math

import numpy as np
import torch

from speechain_tpu_torch.ops.cuda_build import (SMEM_LIMIT, CudaKernel,
                                                F, I, P, aligned,
                                                check_cuda_args, stream_ptr)
from speechain_tpu_torch.ops.cuda_ffn import _sm_count
from speechain_tpu_torch.ops.frontend import (FrontendConfig, dft_filterbank,
                                              dft_folds, folded_dft_basis,
                                              frontend_impl, hann_window,
                                              mel_bands, mel_filterbank,
                                              num_frames, to_float_wave)

KERNEL = CudaKernel(
    name="logmel", source="logmel.cu",
    symbols={"logmel_forward": [P, P, P, P, P, P, P, I, I, I, I, I, I, I, I,
                                I, I, I, I, I, I, F, I, I, F, F, I, P]},
    replaces={"logmel_forward":
              "speechain_tpu/ops/pallas_logmel.py:110"})

# csrc/logmel.cu's constants
WARPS = 8                 # warps a block
TB = 7                    # bins a lane in each pass
BINS = 32 * TB            # bins a pass
ROW = 4 * 32 * 4          # floats of one staged basis row of a pass
KC = 16                   # basis rows a ring chunk
STAGES = 2                # chunks in the ring
EO_ROW = 2 * 8 * WARPS + 4    # floats of one row's e / o columns
LOW_ROW = 16              # floats of a low-basis row
LR = 2 * KC               # low-bin rows a chunk
CH = KC * ROW + LR * LOW_ROW  # floats of a staged chunk
XS_ROW = 8 * WARPS + 1    # floats of one row of the low bins' samples
FRAMES_PER_WARP = (2, 4, 5, 6, 7)   # TF of the built instances
SMS = 132                 # SMs of the H100 SXM: the reckoning without a card
L2_BYTES_PER_CYCLE = 2800     # ~5.5 TB/s of L2 reads at 1.98 GHz


def _cdiv(a: int, b: int) -> int:
    return -(-a // b)


def smem_bytes(tt: int, S: int, N: int, F_: int, low: int, nnz: int,
               n_mels: int) -> int:
    """Dynamic shared bytes of a logmel_tile block of ``tt`` frames
    (``smem_floats``): the ring, two e / o chunks, the power tile, the
    segment, two chunks of the low bins' samples, the band weights and
    the band table."""
    def r4(n):
        return _cdiv(n, 4) * 4
    return 4 * (STAGES * CH + 2 * KC * EO_ROW + r4(tt * F_)
                + r4((tt - 1) * S + N) + (r4(2 * LR * XS_ROW) if low else 0)
                + r4(nnz) + 2 * n_mels + 1)


def _cycles(blocks: int, rows: int, tf: int, sms: int) -> float:
    """SM cycles of a launch of ``blocks`` blocks of ``tf`` frames a warp
    over ``rows`` staged basis rows: the busiest SM's blocks, each row
    max(its 8 warps' 14 TF FMAs over 4 schedulers, their shared loads'
    wavefronts of 128 bytes: 16 of basis and 2 or 4 of e / o a warp), or
    the basis rows all blocks read from L2 (ROW floats a row) at
    L2_BYTES_PER_CYCLE, whichever is longer."""
    per_row = max(WARPS * 14 * tf / 4, WARPS * (16 + 2 * _cdiv(tf, 4)))
    return max(_cdiv(blocks, sms) * rows * per_row,
               blocks * rows * 4 * ROW / L2_BYTES_PER_CYCLE)


def geometry(cfg: FrontendConfig, B: int, L: int, sm_count: int = SMS,
             tf: int = None) -> dict:
    """The launch for a (B, L) batch at ``sm_count`` SMs: frames a warp
    ``tf`` (the pick, unless given) and a block ``frames``, ``grid`` (tiles
    an utterance, B), ``threads``, ``smem`` bytes, ``variant`` ("folded" or
    "direct"), basis ``rows`` a pass and ``passes`` of BINS bins."""
    N, hop, F_ = cfg.fft, cfg.hop, cfg.n_freqs
    T = int(num_frames(L, N, hop, cfg.center))
    S = min(hop, N)
    fold = dft_folds(cfg)
    nnz, low = band_counts(cfg)
    fits = [t for t in FRAMES_PER_WARP
            if smem_bytes(WARPS * t, S, N, F_, low, nnz,
                          cfg.n_mels) <= SMEM_LIMIT]
    if tf is None:
        if not fits:
            raise ValueError(f"log-Mel: n_fft={N}, {F_} bins need more "
                             "shared memory than a block has")
        rows = _cdiv(N // 2 if fold else N, KC) * KC * _cdiv(F_, BINS)
        tf = min(fits, key=lambda t: (
            _cycles(B * _cdiv(T, WARPS * t), rows, t, sm_count), -t))
    elif tf not in fits:
        raise ValueError(f"log-Mel: no built instance of {tf} frames a warp "
                         f"fits n_fft={N}, {F_} bins")
    tt = WARPS * tf
    return dict(tf=tf, frames=tt, grid=(_cdiv(T, tt), B), threads=32 * WARPS,
                smem=smem_bytes(tt, S, N, F_, low, nnz, cfg.n_mels),
                variant="folded" if fold else "direct",
                rows=N // 2 if fold else N, passes=_cdiv(F_, BINS), low=low,
                nnz=nnz)


def staged_basis(cfg: FrontendConfig) -> np.ndarray:
    """:func:`frontend.folded_dft_basis` as the kernel stages it:
    (passes, chunks, CH) float32. Chunk c of pass p: KC rows of ROW floats
    (rows past the last and bins past n_freq zero; row r's group g (cos
    0-3, cos 4-6, sin 0-3, sin 4-6) of lane l at ``g * 128 + 4 l``, bin p
    BINS + 7 l + (0-3 or 4-6)), then LR rows of :func:`low_basis`, rows
    LR c .. LR c + LR - 1 (zeros where no bin is summed again, past n_fft
    and past pass 0)."""
    fb = folded_dft_basis(cfg)                          # (rows, 2, F)
    rows, _, F_ = fb.shape
    passes, nc = _cdiv(F_, BINS), _cdiv(rows, KC)
    main = np.zeros((passes, nc * KC, 4, 32, 4), np.float32)
    padded = np.zeros((rows, 2, passes * BINS), np.float32)
    padded[:, :, :F_] = fb
    lanes = padded.reshape(rows, 2, passes, 32, TB).transpose(2, 0, 1, 3, 4)
    for half in (0, 1):
        main[:, :rows, 2 * half, :, :] = lanes[:, :, half, :, :4]
        main[:, :rows, 2 * half + 1, :, :3] = lanes[:, :, half, :, 4:]
    low = np.zeros((nc * LR, LOW_ROW), np.float32)
    if band_counts(cfg)[1]:
        lb = low_basis(cfg)[:nc * LR]
        low[:len(lb)] = lb
    lows = np.zeros((passes, nc, LR * LOW_ROW), np.float32)
    lows[0] = low.reshape(nc, LR * LOW_ROW)
    return np.ascontiguousarray(np.concatenate(
        [main.reshape(passes, nc, KC * ROW), lows], axis=2))


def band_weights(cfg: FrontendConfig):
    """(mel_w, mel_lo, mel_off): each filter's weights over its band of
    ``mel_filterbank`` (:func:`frontend.mel_bands`), filter after filter
    (nnz = mel_off[-1] of them, then one zero), float32; the bands' first
    bins and offsets into mel_w, int32."""
    fb = mel_filterbank(cfg.n_freqs, cfg.n_mels, cfg.sr, cfg.fmin, cfg.fmax,
                        cfg.mel_scale, cfg.mel_norm)
    lo, hi = mel_bands(fb)
    off = np.concatenate([[0], np.cumsum(hi - lo)]).astype(np.int32)
    w = np.concatenate([fb[lo[m]:hi[m], m] for m in range(cfg.n_mels)]
                       + [np.zeros(1, np.float32)]).astype(np.float32)
    return w, lo, off


@functools.lru_cache(maxsize=16)
def band_counts(cfg: FrontendConfig):
    """(nnz, low): the band weights' count, and the bins the kernel sums
    again by the direct DFT: TB where the DFT is folded (n_freq >= TB) and
    a mel filter weighs a bin below TB, else 0."""
    _, lo, off = band_weights(cfg)
    used = lo[np.diff(off) > 0]
    low = TB if (dft_folds(cfg) and cfg.n_freqs >= TB and used.size
                 and used.min() < TB) else 0
    return int(off[-1]), low


def low_basis(cfg: FrontendConfig) -> np.ndarray:
    """(n_fft, LOW_ROW) float32: by sample, :func:`frontend.dft_filterbank`'s
    cos of bins 0 .. TB - 1, a zero, their -sin, a zero; bit for bit the
    plain version's values."""
    basis = dft_filterbank(cfg.fft, hann_window(cfg.win), cfg.onesided,
                           cfg.normalized)
    F_ = cfg.n_freqs
    out = np.zeros((cfg.fft, LOW_ROW), np.float32)
    out[:, :TB] = basis[:TB].T
    out[:, LOW_ROW // 2:LOW_ROW // 2 + TB] = basis[F_:F_ + TB].T
    return out


@functools.lru_cache(maxsize=16)
def kernel_constants(cfg: FrontendConfig, device: torch.device):
    """(basis, mel_w, mel_band) on ``device`` as the kernel reads them
    (:func:`staged_basis`, :func:`band_weights`: mel_band is mel_lo then
    mel_off); built once per (config, device)."""
    w, lo, off = band_weights(cfg)
    return tuple(aligned(torch.from_numpy(np.ascontiguousarray(a)).to(device))
                 for a in (staged_basis(cfg), w,
                           np.concatenate([lo, off]).astype(np.int32)))


def logmel_plain(wave: torch.Tensor, wave_len: torch.Tensor,
                 cfg: FrontendConfig):
    """The kernel's function in plain PyTorch: (feat (B, T, n_mels) fp32,
    feat_len (B,) int32)."""
    _check_cfg(cfg)
    feat, feat_len, _, _ = frontend_impl(wave, wave_len, cfg)
    return feat, feat_len


def cuda_logmel(wave: torch.Tensor, wave_len: torch.Tensor,
                cfg: FrontendConfig):
    """wave (B, L) float32 or int16 PCM -> (feat (B, T, n_mels) float32,
    feat_len (B,) int32), zero beyond ``feat_len``.

    A CPU tensor takes :func:`logmel_plain`; a CUDA tensor takes the kernel.
    """
    if not wave.is_cuda:
        return logmel_plain(wave, wave_len, cfg)
    return _launch(wave, wave_len, cfg)


def _launch(wave, wave_len, cfg, tf=None):
    """The kernel on a CUDA batch, with ``tf`` frames a warp if given (the
    smoke run's sweep), else :func:`geometry`'s pick."""
    _check_cfg(cfg)
    wave = to_float_wave(wave).contiguous()
    wave_len = wave_len.to(device=wave.device, dtype=torch.int32).contiguous()
    B, L = wave.shape
    n_fft, hop = cfg.fft, cfg.hop
    if cfg.center and L <= n_fft // 2:
        raise ValueError(f"reflect padding needs L > n_fft//2 ({n_fft // 2}), "
                         f"got L={L}")
    T = int(num_frames(L, n_fft, hop, cfg.center))
    if T < 1:
        raise ValueError(f"waveform of {L} samples holds no frame")
    geo = geometry(cfg, B, L, _sm_count(wave.device), tf)
    basis, mel_w, mel_band = kernel_constants(cfg, wave.device)
    check_cuda_args("cuda_logmel", {"mel_band": (torch.int32,),
                                    "*": (torch.float32,)},
                    wave=wave, basis=basis, mel_w=mel_w, mel_band=mel_band)
    out = torch.empty(B, T, cfg.n_mels, device=wave.device,
                      dtype=torch.float32)
    log_div = (math.log(cfg.log_base) if cfg.log_base is not None else 1.0)
    feat_len = num_frames(wave_len, n_fft, hop, cfg.center).to(torch.int32)
    KERNEL.launch(
        "logmel_forward", wave.data_ptr(), wave_len.data_ptr(),
        feat_len.data_ptr(), basis.data_ptr(), mel_w.data_ptr(), mel_band.data_ptr(), out.data_ptr(), B, L, T,
        n_fft, hop, cfg.n_freqs, cfg.n_mels, geo["nnz"], geo["rows"],
        geo["passes"], int(geo["variant"] == "folded"),
        geo["low"], int(cfg.center),
        int(cfg.preemphasis is not None),
        float(cfg.preemphasis if cfg.preemphasis is not None else 0.0),
        int(cfg.mag_spec), int(cfg.logging), float(cfg.clamp), log_div,
        geo["tf"], stream_ptr(wave))
    return out, feat_len


def built_layout(cfg: FrontendConfig, B: int, L: int, tf: int) -> dict:
    """The launch the built kernel's host code makes (``logmel_layout``)
    for ``tf`` frames a warp, in :func:`geometry`'s keys grid, threads
    and smem. Builds the kernel; needs a card."""
    fn = KERNEL.lib.logmel_layout
    fn.argtypes = [I] * 9 + [P]
    out = (ctypes.c_longlong * 4)()
    T = int(num_frames(L, cfg.fft, cfg.hop, cfg.center))
    nnz, low = band_counts(cfg)
    err = fn(tf, B, T, cfg.fft, cfg.hop, cfg.n_freqs, low, nnz, cfg.n_mels,
             out)
    if err != 0:
        raise RuntimeError(f"logmel_layout failed with cudaError {err}")
    return {"grid": (out[0], out[1]), "threads": out[2], "smem": out[3]}


def _check_cfg(cfg: FrontendConfig) -> None:
    if cfg.pre_stft_norm is not None:
        raise NotImplementedError(
            "the fused log-Mel kernel applies no pre-STFT norm; use "
            "ops.frontend.frontend_impl")
