"""Conformer convolution-module front half as one CUDA kernel
(``csrc/convmod.cu``).

Replaces ``speechain_tpu/ops/pallas_convmod.py::fused_conv_glu_dw``
(forward ``pl.pallas_call`` at :273, body ``_fwd_kernel`` :131):

    u = depthwise_K(glu(x W1^T + b1)) + dwb      ('SAME', zero padding at
                                                  the array's time edges)
    s[c] = sum u, ss[c] = sum u^2                 (over every (b, t))

with the pointwise output rounded to the compute dtype before the GLU and
the statistics taken from the rounded u. Padded frames of shorter
utterances are not masked: the reference BatchNorm sees them too
(``nn/conformer.py:8-11``), and evaluation BatchNorm ignores s and ss.

What bounds it on the H100: the pointwise product (B x T x 256 x 512 MACs,
0.8 GFLOP at conformer-small) against ~3 MB of x and u, so the
operations; the design recomputes the product for each 64-frame tile plus
its 30-frame halo (blocks need no neighbour), keeps the (rows, 2 x 64)
pointwise output in shared memory, and reduces the per-block statistics
in a second small kernel in a fixed order, since blocks cannot carry a
sum across the grid the way the TPU kernel does.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

from speechain_tpu_torch.ops.cuda_build import (CudaKernel, I, P,
                                                check_cuda_args, stream_ptr)

KERNEL = CudaKernel(
    name="convmod", source="convmod.cu",
    symbols={"convmod_forward": [P, P, P, P, P, P, P, P, P, I, I, I, I, I,
                                 P]},
    replaces={"convmod_forward":
              "speechain_tpu/ops/pallas_convmod.py:273"})

TILE_T = 64               # csrc/convmod.cu TT
CHANNEL_BLOCK = 64        # csrc/convmod.cu CB
MAX_K = 33                # csrc/convmod.cu KMAX


def conv_glu_dw_plain(x, w1, b1, dwk, dwb):
    """The kernel's function in plain PyTorch, same rounding points.

    x (B, T, C); w1 (2C, C); b1 (2C,); dwk (C, K); dwb (C,).
    Returns (u (B, T, C) in x's dtype, s (C,) float32, ss (C,) float32)."""
    cd = x.dtype
    B, T, C = x.shape
    K = dwk.shape[-1]
    pad = (K - 1) // 2
    z = (x.float() @ w1.float().t() + b1.to(cd).float()).to(cd).float()
    a = z[..., :C] * torch.sigmoid(z[..., C:])
    ap = F.pad(a, (0, 0, pad, K - 1 - pad))
    w = dwk.float().reshape(C, K)
    u = ap[:, 0:T] * w[:, 0]
    for k in range(1, K):
        u = u + ap[:, k:k + T] * w[:, k]
    u = (u + dwb.to(cd).float()).to(cd)
    uf = u.float()
    return u, uf.sum((0, 1)), (uf * uf).sum((0, 1))


def cuda_conv_glu_dw(x: torch.Tensor, w1: torch.Tensor, b1: torch.Tensor,
                     dwk: torch.Tensor, dwb: torch.Tensor):
    """x (B, T, C) float32 or bfloat16; w1 (2C, C), b1 (2C,), dwb (C,) in
    x's dtype; dwk (C, K) float32. Returns (u, s, ss) as
    :func:`conv_glu_dw_plain`.

    A CPU tensor takes :func:`conv_glu_dw_plain`; a CUDA tensor takes the
    kernel.
    """
    if not x.is_cuda:
        return conv_glu_dw_plain(x, w1, b1, dwk, dwb)
    B, T, C = x.shape
    cd = x.dtype
    if cd not in (torch.float32, torch.bfloat16):
        raise ValueError(f"cuda_conv_glu_dw: unsupported dtype {cd}")
    dwk = dwk.reshape(C, -1)
    K = dwk.shape[1]
    if C % CHANNEL_BLOCK or K > MAX_K:
        raise ValueError(f"cuda_conv_glu_dw: needs C % {CHANNEL_BLOCK} == 0 "
                         f"and K <= {MAX_K}, got C={C}, K={K}")
    if w1.shape != (2 * C, C) or b1.shape != (2 * C,) or dwb.shape != (C,):
        raise ValueError("cuda_conv_glu_dw: weight shapes do not fit x")
    check_cuda_args("cuda_conv_glu_dw", {"dwk": (torch.float32,), "*": (cd,)},
                    x=x, w1=w1, b1=b1, dwk=dwk, dwb=dwb)
    tiles = -(-T // TILE_T)
    u = torch.empty_like(x)
    part = torch.empty(B * tiles, 2, C, device=x.device, dtype=torch.float32)
    s = torch.empty(C, device=x.device, dtype=torch.float32)
    ss = torch.empty(C, device=x.device, dtype=torch.float32)
    KERNEL.launch(
        "convmod_forward", x.data_ptr(), w1.data_ptr(), b1.data_ptr(),
        dwk.data_ptr(), dwb.data_ptr(), u.data_ptr(), part.data_ptr(),
        s.data_ptr(), ss.data_ptr(), B, T, C, K,
        0 if cd == torch.float32 else 1, stream_ptr(x))
    return u, s, ss
