"""Conformer convolution-module front half as CUDA kernels, forward and
backward (``csrc/convmod.cu``).

Replaces ``speechain_tpu/ops/pallas_convmod.py::fused_conv_glu_dw``
(forward ``pl.pallas_call`` at :273, body ``_fwd_kernel`` :131; backward at
:301, body ``_bwd_kernel`` :165, plus the depthwise weight gradient that
the JAX wrapper computes outside the kernel, :324-336):

    u = depthwise_K(glu(x W1^T + b1)) + dwb      ('SAME', zero padding at
                                                  the array's time edges)
    s[c] = sum u, ss[c] = sum u^2                 (over every (b, t))

with the pointwise output rounded to the compute dtype before the GLU and
the statistics taken from the rounded u. Padded frames of shorter
utterances are not masked: the reference BatchNorm sees them too
(``nn/conformer.py:8-11``); evaluation BatchNorm ignores s and ss, training
BatchNorm normalises with them (``nn/norms.py::BatchNorm.from_moments``).

What bounds it on the H100: the pointwise product (B x T x 256 x 512 MACs,
0.8 GFLOP at conformer-small, 0.8 us at 989 TFLOP/s; the backward
recomputes it and adds two more of the same size) against ~3.6 MB of x,
W1 and u, 1.1 us at 3.35 TB/s. The forward recomputes the product for
each 64-frame tile plus its K-1 halo frames (blocks need no neighbour),
keeps the (rows, 2 x 64) pointwise output in shared memory, and reduces
the per-block statistics in a second small kernel in a fixed order,
since blocks cannot carry a sum across the grid the way the TPU kernel
does; in bf16 the product runs on the tensor cores (``mma.sync``),
float32 keeps the FMA units. The backward row pass does the same
recomputation, folds the statistics' cotangents into du_tot = du + ds +
2 u dss over the tile and its halo, and writes dz in the compute dtype and
per-block partials of db1, ddwk and ddwb (the depthwise weight gradient
comes from the float32 GLU output, inside the backward); dx = dz W1 and
dW1 = dz^T x are tiled products, and the partials are added in a fixed
order: deterministic, no atomics. In float32 every product runs on the
FMA units; in bf16 the z recompute, dx and dW1 run on the tensor cores
(``mma.sync``), dW1 over ``WG_SPLIT`` row ranges whose float32 partials
are added in order, so the weight gradient fills the card.
"""

from __future__ import annotations

import ctypes

import torch
import torch.nn.functional as F

from speechain_tpu_torch.ops.cuda_build import (CudaKernel, I, P, Q,
                                                aligned, check_cuda_args,
                                                stream_ptr)
from speechain_tpu_torch.ops.cuda_ffn import _as, round_to

KERNEL = CudaKernel(
    name="convmod", source="convmod.cu",
    symbols={"convmod_forward": [P, P, P, P, P, P, P, P, P, I, I, I, I, I,
                                 P],
             "convmod_backward": [P] * 13 + [Q, I, I, I, I, I, P]},
    replaces={"convmod_forward":
              "speechain_tpu/ops/pallas_convmod.py:273",
              "convmod_backward":
              "speechain_tpu/ops/pallas_convmod.py:301"})

TILE_T = 64               # csrc/convmod.cu TT
CHANNEL_BLOCK = 64        # csrc/convmod.cu CB
MAX_K = 33                # csrc/convmod.cu KMAX
# csrc/convmod.cu, the bf16 backward on the tensor cores: z rows a tile
# recomputes (RZP), the depth of a staged chunk (KC, rows padded to LDK),
# the row stride of the bf16 z tile (LDZ), the row ranges of dW1's partial
# sums (WG_SPLIT)
RZP, KC, LDK, LDZ, WG_SPLIT = 96, 64, 72, 136, 8


def part_floats(B: int, T: int, C: int, K: int, dtype: torch.dtype) -> int:
    """Float32 elements of the backward's ``part`` scratch, as the source's
    ``part_need`` reckons them (the entry point refuses a shorter buffer):
    the row pass's per-block partials [db1 | ddwk | ddwb], (B ceil(T /
    64), 2C + C K + C), and in bf16 dW1's WG_SPLIT partial sums
    (WG_SPLIT, 2C, C) after them."""
    rows = B * -(-T // TILE_T) * (2 * C + C * K + C)
    return rows + (WG_SPLIT * 2 * C * C if dtype == torch.bfloat16 else 0)


def tc_smem_bytes() -> dict:
    """Dynamic shared memory of the bf16 kernels: the forward
    ``convmod_fwd_tc`` and the backward's row pass take ``ROWS_TC_SMEM``
    (the z product's two-slot ring of (RZP + 2 CB) rows of KC + 8 bf16,
    which a (and in the backward du_tot; RZP x CB float32 each) replace,
    the RZP x LDZ bf16 z tile, KMAX x CB taps and 4 x 2 CB sums); dx and
    dW1 take ``MM_SMEM`` (two slots of two 64 x LDK tiles)."""
    ring = 2 * (RZP + 2 * CHANNEL_BLOCK) * LDK * 2
    rows = ring + RZP * LDZ * 2 + MAX_K * CHANNEL_BLOCK * 4 \
        + 4 * 2 * CHANNEL_BLOCK * 4
    return {"fwd": rows, "rows": rows, "dx": 2 * 2 * 64 * LDK * 2,
            "wgrad": 2 * 2 * 64 * LDK * 2}


def fwd_tc_grids(B: int, T: int, C: int) -> dict:
    """Blocks of the bf16 forward's two launches (x, y, z), as the
    source's ``fwd_grids`` sets them: ``convmod_fwd_tc`` (one per 64
    frames, 64 channels, utterance) and the fixed-order s / ss sum (128
    channels a block)."""
    return {"fwd": (-(-T // TILE_T), C // CHANNEL_BLOCK, B),
            "fwd_sums": (-(-C // 128), 1, 1)}


def bwd_tc_grids(B: int, T: int, C: int, K: int) -> dict:
    """Blocks of each bf16 backward launch (x, y, z), as the source's
    ``tc_grids`` sets them: the row pass (one per 64 frames, 64 channels,
    utterance), dx (64 x 64 tiles of (N, C)), dW1's partials (64 x 64
    tiles of (2C, C) times WG_SPLIT row ranges) and the two fixed-order
    sums."""
    N = B * T
    return {"rows": (-(-T // TILE_T), C // CHANNEL_BLOCK, B),
            "dx": (C // 64, -(-N // 64), 1),
            "wgrad": (C // 64, 2 * C // 64, WG_SPLIT),
            "sums_dw1": (-(-2 * C * C // 256), 1, 1),
            "sums_part": (-(-(3 * C + C * K) // 256), 1, 1)}


def built_layout(B: int, T: int, C: int, K: int, dtype: torch.dtype) -> dict:
    """The built kernels' layout for a call (``convmod_layout``): ``part``
    the backward's scratch in float32 elements, and in bf16 ``smem`` each
    tensor-core kernel's shared memory (static plus dynamic) and ``grids``
    each launch's blocks, forward and backward: what :func:`part_floats`,
    :func:`tc_smem_bytes`, :func:`fwd_tc_grids` and :func:`bwd_tc_grids`
    reckon without a card. Builds the kernels; needs a card."""
    fn = KERNEL.lib.convmod_layout
    fn.argtypes = [I, I, I, I, I, P]
    out = (ctypes.c_longlong * 26)()
    bf = dtype == torch.bfloat16
    err = fn(1 if bf else 0, B, T, C, K, out)
    if err != 0:
        raise RuntimeError(f"convmod_layout failed with cudaError {err}")
    got = {"part": out[0]}
    if bf:
        got["smem"] = dict(zip(("fwd", "rows", "dx", "wgrad"), out[1:5]))
        got["grids"] = {k: tuple(out[5 + 3 * i:8 + 3 * i]) for i, k in
                        enumerate(("fwd", "fwd_sums", "rows", "dx", "wgrad",
                                   "sums_dw1", "sums_part"))}
    return got


def conv_glu_dw_plain(x, w1, b1, dwk, dwb):
    """The kernels' function in plain PyTorch, same rounding points; its
    autograd is the backward kernel's reference.

    x (B, T, C); w1 (2C, C), b1 (2C,), dwb (C,) in any float dtype (rounded
    to x's dtype at use); dwk (C, 1, K) or (C, K) float32.
    Returns (u (B, T, C) in x's dtype, s (C,) float32, ss (C,) float32)."""
    cd = x.dtype
    B, T, C = x.shape
    K = dwk.shape[-1]
    pad = (K - 1) // 2
    z = round_to(x.float() @ round_to(w1.float(), cd).t()
                 + round_to(b1.float(), cd), cd)
    a = z[..., :C] * torch.sigmoid(z[..., C:])
    ap = F.pad(a, (0, 0, pad, K - 1 - pad))
    w = dwk.float().reshape(C, K)
    u = ap[:, 0:T] * w[:, 0]
    for k in range(1, K):
        u = u + ap[:, k:k + T] * w[:, k]
    u = (u + round_to(dwb.float(), cd)).to(cd)
    uf = u.float()
    return u, uf.sum((0, 1)), (uf * uf).sum((0, 1))


def _launch_forward(x, w1c, b1c, dwkf, dwbc):
    """The forward kernel: float32 runs the FMA kernel, bf16 the
    tensor-core one (``convmod_fwd_tc``); any other dtype raises."""
    if x.dtype not in (torch.float32, torch.bfloat16):
        raise ValueError(f"convmod_forward: unsupported dtype {x.dtype}")
    B, T, C = x.shape
    K = dwkf.shape[1]
    tiles = -(-T // TILE_T)
    u = torch.empty_like(x)
    part = torch.empty(B * tiles, 2, C, device=x.device, dtype=torch.float32)
    s = torch.empty(C, device=x.device, dtype=torch.float32)
    ss = torch.empty(C, device=x.device, dtype=torch.float32)
    KERNEL.launch(
        "convmod_forward", x.data_ptr(), w1c.data_ptr(), b1c.data_ptr(),
        dwkf.data_ptr(), dwbc.data_ptr(), u.data_ptr(), part.data_ptr(),
        s.data_ptr(), ss.data_ptr(), B, T, C, K,
        0 if x.dtype == torch.float32 else 1, stream_ptr(x))
    return u, s, ss


def convmod_backward(x, w1c, b1c, dwkf, u, du, ds, dss):
    """The backward kernel: (dx in x's dtype, float32 dW1 (2C, C), db1
    (2C,), ddwk (C, K), ddwb (C,)) for the cotangents du (B, T, C) in x's
    dtype and ds, dss (C,) float32 of the forward's (u, s, ss)."""
    B, T, C = x.shape
    K = dwkf.shape[1]
    cd = x.dtype
    check_cuda_args("convmod_backward",
                    {"ds": (torch.float32,), "dss": (torch.float32,),
                     "dwk": (torch.float32,), "*": (cd,)},
                    x=x, w1=w1c, b1=b1c, dwk=dwkf, u=u, du=du, ds=ds,
                    dss=dss)
    dev, f32 = x.device, torch.float32
    W = 2 * C + C * K + C
    dz = torch.empty(B * T, 2 * C, device=dev, dtype=cd)
    n_part = part_floats(B, T, C, K, cd)
    part = torch.empty(n_part, device=dev, dtype=f32)
    dx = torch.empty_like(x)
    dw1 = torch.empty(2 * C, C, device=dev, dtype=f32)
    sums = torch.empty(W, device=dev, dtype=f32)
    KERNEL.launch(
        "convmod_backward", x.data_ptr(), w1c.data_ptr(), b1c.data_ptr(),
        dwkf.data_ptr(), u.data_ptr(), du.data_ptr(), ds.data_ptr(),
        dss.data_ptr(), dz.data_ptr(), part.data_ptr(), dx.data_ptr(),
        dw1.data_ptr(), sums.data_ptr(), n_part, B, T, C, K,
        0 if cd == torch.float32 else 1, stream_ptr(x))
    db1, ddwk, ddwb = sums.split([2 * C, C * K, C])
    return dx, dw1, db1, ddwk.reshape(C, K), ddwb


class _ConvGluDw(torch.autograd.Function):
    """The forward kernel, with the backward kernel as its gradient; u, s
    and ss are all differentiable."""

    @staticmethod
    def forward(ctx, x, w1, b1, dwk, dwb):
        cd = x.dtype
        C = x.shape[-1]
        w1c, b1c, dwbc = aligned(_as(w1, cd)), _as(b1, cd), _as(dwb, cd)
        dwkf = _as(dwk.reshape(C, -1), torch.float32)
        u, s, ss = _launch_forward(x, w1c, b1c, dwkf, dwbc)
        ctx.save_for_backward(x, w1c, b1c, dwkf, u)
        ctx.cfg = (w1.dtype, b1.dtype, dwk.dtype, dwk.shape, dwb.dtype)
        return u, s, ss

    @staticmethod
    def backward(ctx, du, ds, dss):
        x, w1c, b1c, dwkf, u = ctx.saved_tensors
        w1t, b1t, dwkt, dwk_shape, dwbt = ctx.cfg
        dx, dw1, db1, ddwk, ddwb = convmod_backward(
            x, w1c, b1c, dwkf, u, _as(du, x.dtype), _as(ds, torch.float32),
            _as(dss, torch.float32))
        return (dx, dw1.to(w1t), db1.to(b1t),
                ddwk.reshape(dwk_shape).to(dwkt), ddwb.to(dwbt))


def cuda_conv_glu_dw(x: torch.Tensor, w1: torch.Tensor, b1: torch.Tensor,
                     dwk: torch.Tensor, dwb: torch.Tensor):
    """x (B, T, C) float32 or bfloat16; w1 (2C, C), b1 (2C,), dwb (C,) in
    any float dtype (rounded to x's dtype at use, gradients returned in
    theirs); dwk (C, 1, K) or (C, K), used in float32. Returns (u, s, ss)
    as :func:`conv_glu_dw_plain`, differentiable in x and the weights.

    A CPU tensor takes :func:`conv_glu_dw_plain`; a CUDA tensor takes the
    kernels.
    """
    if not x.is_cuda:
        return conv_glu_dw_plain(x, w1, b1, dwk, dwb)
    B, T, C = x.shape
    cd = x.dtype
    if cd not in (torch.float32, torch.bfloat16):
        raise ValueError(f"cuda_conv_glu_dw: unsupported dtype {cd}")
    K = dwk.shape[-1]
    if C % CHANNEL_BLOCK or K > MAX_K or dwk.numel() != C * K:
        raise ValueError(f"cuda_conv_glu_dw: needs C % {CHANNEL_BLOCK} == 0 "
                         f"and K <= {MAX_K}, got C={C}, K={K}")
    if w1.shape != (2 * C, C) or b1.shape != (2 * C,) or dwb.shape != (C,):
        raise ValueError("cuda_conv_glu_dw: weight shapes do not fit x")
    x = aligned(x)                         # 16-byte copies of x's rows
    check_cuda_args("cuda_conv_glu_dw", (torch.float32, torch.bfloat16),
                    x=x, w1=w1, b1=b1, dwk=dwk, dwb=dwb)
    if torch.is_grad_enabled() and any(
            t.requires_grad for t in (x, w1, b1, dwk, dwb)):
        return _ConvGluDw.apply(x, w1, b1, dwk, dwb)
    return _launch_forward(x, _as(w1, cd), _as(b1, cd),
                           _as(dwk.reshape(C, K), torch.float32),
                           _as(dwb, cd))
