"""Fused waveform -> log-Mel CUDA kernel (``csrc/logmel.cu``).

Replaces ``speechain_tpu/ops/pallas_logmel.py::pallas_logmel`` (the
``pl.pallas_call`` at :110, body ``_logmel_kernel`` :38): windowed-DFT
product, power, mel product and clamp/log, with the complex spectrum kept
on chip.

On the H100 the work is float32 arithmetic: at conformer-small (16 x 8 s)
the DFT alone is 16 x 801 x 400 x 402 multiply-adds (4.1 GFLOP) against
12 MB of waveform and features, so the bound is the card's float32 rate,
not its memory. The kernel has to stay true float32 (tensor-core TF32
breaks the < 1e-4 log-Mel contract), so it runs on the FMA units: one
block frames 32 frames straight from the waveform by index arithmetic
(pre-emphasis, the utterance-length mask and the reflect centre padding
applied on the fly, no framed copy in device memory), keeps them and
their power spectrum in shared memory, and writes only the (32, n_mels)
log-Mel tile. The TPU kernel's 128-frame tile padding is not carried over.
"""

from __future__ import annotations

import math

import torch

from speechain_tpu_torch.ops.cuda_build import (SMEM_LIMIT, CudaKernel,
                                                F, I, P,
                                                check_cuda_args, stream_ptr)
from speechain_tpu_torch.ops.frontend import (FrontendConfig,
                                              frontend_constants, frontend_impl,
                                              num_frames, to_float_wave)

KERNEL = CudaKernel(
    name="logmel", source="logmel.cu",
    symbols={"logmel_forward": [P, P, P, P, P, P, I, I, I, I, I, I, I, I, I,
                                F, I, I, F, F, P]},
    replaces={"logmel_forward":
              "speechain_tpu/ops/pallas_logmel.py:110"})

TILE_FRAMES = 32          # frames per block; must match csrc/logmel.cu


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
    smem = 4 * TILE_FRAMES * (n_fft + cfg.n_freqs)
    if smem > SMEM_LIMIT:
        raise ValueError(f"n_fft={n_fft} needs {smem} B of shared memory")
    basis, mel_fb = frontend_constants(cfg, wave.device)
    check_cuda_args("cuda_logmel", (torch.float32,), wave=wave, basis=basis,
                    mel_fb=mel_fb)
    out = torch.empty(B, T, cfg.n_mels, device=wave.device,
                      dtype=torch.float32)
    log_div = (math.log(cfg.log_base) if cfg.log_base is not None else 1.0)
    feat_len = num_frames(wave_len, n_fft, hop, cfg.center).to(torch.int32)
    KERNEL.launch(
        "logmel_forward", wave.data_ptr(), wave_len.data_ptr(),
        feat_len.data_ptr(), basis.data_ptr(), mel_fb.data_ptr(),
        out.data_ptr(),
        B, L, T, n_fft, hop, cfg.n_freqs, cfg.n_mels, int(cfg.center),
        int(cfg.preemphasis is not None),
        float(cfg.preemphasis if cfg.preemphasis is not None else 0.0),
        int(cfg.mag_spec), int(cfg.logging), float(cfg.clamp), log_div,
        stream_ptr(wave))
    return out, feat_len


def _check_cfg(cfg: FrontendConfig) -> None:
    if cfg.pre_stft_norm is not None:
        raise NotImplementedError(
            "the fused log-Mel kernel applies no pre-STFT norm; use "
            "ops.frontend.frontend_impl")
