"""LayerNorm as CUDA kernels, forward and backward (``csrc/layernorm.cu``).

Replaces ``speechain_tpu/ops/pallas_layernorm.py::fused_layer_norm``
(forward ``pl.pallas_call`` at :117, body ``_fwd_kernel`` :56; backward at
:139, body ``_bwd_kernel`` :68):

    mu = mean(x), var = mean(x^2) - mu^2 (the fast variance), rstd =
    rsqrt(var + eps), y = (x - mu) * rstd * scale + bias

over the last axis, statistics in float32, y in x's dtype; the forward
saves mu and rstd (float32, one per row) for the backward, which forms
dx = rstd * (gs - mean(gs) - xhat * mean(gs * xhat)) with gs = g * scale
in x's dtype, and dscale = sum g * xhat, dbias = sum g over every row, in
the parameters' dtype (float32), as ``_ln_bwd`` (:149-150) returns them.

What bounds it on the H100: latency. At the conformer encoder's N =
3184 rows of D = 256 in bf16 the forward moves 3.29 MB (x read, y
written, mu/rstd written: 0.98 us at 3.35 TB/s), the backward ~4.9 MB
(1.47 us), the decode step's N = 256 rows 0.26 MB: the kernels take as
long as their chains of memory round trips. The forward gives each row
one warp, FWD_WARPS a block, and loads the row, scale and bias before
its shuffle reduction; the backward gives each of at most one block an
SM a run of rows, whose parameter-gradient sums stay in registers, sized
from the shape and the card's SM count by :func:`backward_geometry`; a
second kernel adds the blocks' partials in a fixed order (the TPU kernel
accumulates them over a sequential grid): deterministic, no atomics.

Off by default, as in the JAX package (:37-53): ``SPEECHAIN_FORCE_FUSED_LN``
turns it on and ``SPEECHAIN_DISABLE_PALLAS`` keeps it off even then (the
reference's code checks the disable first, whatever its comment says);
``nn/norms.py::LayerNorm`` takes the route only where the reference's gate
does.
"""

from __future__ import annotations

import ctypes
import os
from typing import Tuple

import torch

from speechain_tpu_torch.ops.cuda_build import (CudaKernel, F, I, P, aligned,
                                                check_cuda_args, stream_ptr)
from speechain_tpu_torch.ops.cuda_ffn import _as, _sm_count

KERNEL = CudaKernel(
    name="layernorm", source="layernorm.cu",
    symbols={"layer_norm_forward": [P, P, P, P, P, P, I, I, F, I, I, P],
             "layer_norm_backward": [P, P, P, P, P, P, P, P, I, I, I, I, I,
                                     I, P]},
    replaces={"layer_norm_forward":
              "speechain_tpu/ops/pallas_layernorm.py:117",
              "layer_norm_backward":
              "speechain_tpu/ops/pallas_layernorm.py:139"})

MAX_D = 1024        # csrc/layernorm.cu: a lane keeps <= 32 columns
MAX_WARPS = 8       # csrc/layernorm.cu: warps a block
MAX_CHUNK = 4       # csrc/layernorm.cu: backward rows x vectors a lane
                    # loads at once
SUM_COLS = 32       # csrc/layernorm.cu: the partials' sum, columns a block
SUM_WARPS = 8       # and warps, each adding a segment of the partials
SMS = 132           # streaming multiprocessors of the H100 SXM: the
                    # reckoning without a card; a launch takes the card's
FWD_WARPS = 4       # forward: warps (rows) a block
BWD_MIN_ROWS = 8    # backward: rows a run holds at least, where N allows


def _cdiv(a: int, b: int) -> int:
    return -(-a // b)


def sm_count(device: torch.device) -> int:
    """Streaming multiprocessors of the card ``device`` names (SMS for
    the CPU), from which both launches are sized."""
    return _sm_count(device) if device.type == "cuda" else SMS


def vectors(D: int, dtype: torch.dtype) -> int:
    """NV, the 16-byte vectors a lane keeps of a row: the least power of
    two covering D / (32 x values a vector)."""
    need = _cdiv(D, 32 * (16 // dtype.itemsize))
    nv = 1
    while nv < need:
        nv *= 2
    return nv


def chunk_rows(nv: int, rows: int) -> int:
    """R, the rows a backward warp loads at once: the most of 4, 2 that is
    at most ``rows`` with R x NV <= MAX_CHUNK, else 1."""
    for r in (4, 2):
        if r <= rows and r * nv <= MAX_CHUNK:
            return r
    return 1


def backward_geometry(N: int, D: int, dtype: torch.dtype,
                      sms: int = SMS) -> Tuple[int, int, int]:
    """(P, W, R): row runs (blocks), warps a block and rows a warp loads
    at once of the backward. At most one run an SM, of at least
    BWD_MIN_ROWS rows where N allows (fewer, fuller blocks leave fewer
    partials to add); rpb = ceil(N / P) rows a run, P then trimmed so that
    no run is empty; W = min(8, rpb) warps; R from the rows each warp
    takes."""
    P = max(1, min(N, sms, _cdiv(N, BWD_MIN_ROWS)))
    rpb = _cdiv(N, P)
    P = _cdiv(N, rpb)
    W = min(MAX_WARPS, rpb)
    return P, W, chunk_rows(vectors(D, dtype), _cdiv(rpb, W))


def layout(N: int, D: int, dtype: torch.dtype, sms: int = SMS) -> dict:
    """The launches of a call at ``sms`` SMs, as ``layer_norm_layout``
    reckons them on the card: NV, the forward's (grid, threads), the
    backward rows' (grid, threads, dynamic shared bytes) and the
    partials' sum's (grid, threads)."""
    P, Wb, _ = backward_geometry(N, D, dtype, sms)
    return {"nv": vectors(D, dtype),
            "fwd": (_cdiv(N, FWD_WARPS), 32 * FWD_WARPS),
            "bwd": (P, 32 * Wb, 4 * Wb * D),
            "sum": (_cdiv(2 * D, SUM_COLS), SUM_COLS * SUM_WARPS)}


def built_layout(N: int, D: int, dtype: torch.dtype) -> dict:
    """:func:`layout` as the built kernels' host code reckons it
    (``layer_norm_layout``) for the picks at the card's SM count. Builds
    the kernels; needs a card."""
    fn = KERNEL.lib.layer_norm_layout
    fn.argtypes = [I] * 7 + [P]
    out = (ctypes.c_longlong * 8)()
    sms = sm_count(torch.device("cuda", torch.cuda.current_device()))
    err = fn(N, D, _dtype_code_of(dtype), FWD_WARPS,
             *backward_geometry(N, D, dtype, sms), out)
    if err != 0:
        raise RuntimeError(f"layer_norm_layout failed with cudaError {err}")
    return {"nv": out[0], "fwd": tuple(out[1:3]), "bwd": tuple(out[3:6]),
            "sum": tuple(out[6:8])}


def fused_ln_enabled() -> bool:
    """The reference's switch (``pallas_layernorm.py:37-53``): on when
    ``SPEECHAIN_FORCE_FUSED_LN`` is set, off whenever
    ``SPEECHAIN_DISABLE_PALLAS`` is."""
    if os.environ.get("SPEECHAIN_DISABLE_PALLAS"):
        return False
    return bool(os.environ.get("SPEECHAIN_FORCE_FUSED_LN"))


def layer_norm_plain(x: torch.Tensor, scale: torch.Tensor,
                     bias: torch.Tensor, eps: float = 1e-6) -> torch.Tensor:
    """The kernels' function in plain PyTorch: float32 statistics with the
    fast variance, output in x's dtype; its autograd is the backward
    kernel's reference."""
    xf = x.float()
    mu = xf.mean(-1, keepdim=True)
    var = (xf * xf).mean(-1, keepdim=True) - mu * mu
    y = (xf - mu) * torch.rsqrt(var + eps)
    return (y * scale.float() + bias.float()).to(x.dtype)


def _dtype_code_of(dtype: torch.dtype) -> int:
    if dtype not in (torch.float32, torch.bfloat16):
        raise ValueError(f"fused_layer_norm: unsupported dtype {dtype}")
    return 0 if dtype == torch.float32 else 1


def _launch_forward(x2, sf, bf, eps, stats=True):
    """The forward kernel: (y, mu, rstd), or (y, None, None) without
    ``stats``."""
    N, D = x2.shape
    y = torch.empty_like(x2)
    mu = rstd = None
    if stats:
        mu = torch.empty(N, device=x2.device, dtype=torch.float32)
        rstd = torch.empty(N, device=x2.device, dtype=torch.float32)
    KERNEL.launch("layer_norm_forward", x2.data_ptr(), sf.data_ptr(),
                  bf.data_ptr(), y.data_ptr(),
                  None if mu is None else mu.data_ptr(),
                  None if rstd is None else rstd.data_ptr(), N, D,
                  float(eps), _dtype_code_of(x2.dtype), FWD_WARPS,
                  stream_ptr(x2))
    return y, mu, rstd


def layer_norm_backward(x2, sf, mu, rstd, g2):
    """The backward kernels: (dx (N, D) in x's dtype, dscale (D,) and dbias
    (D,) float32) for the cotangent g2 (N, D) in x's dtype."""
    N, D = x2.shape
    check_cuda_args("layer_norm_backward",
                    {"x": (x2.dtype,), "g": (x2.dtype,),
                     "*": (torch.float32,)},
                    x=x2, scale=sf, mu=mu, rstd=rstd, g=g2)
    P_, W, R = backward_geometry(N, D, x2.dtype, sm_count(x2.device))
    dx = torch.empty_like(x2)
    part = torch.empty(P_, 2 * D, device=x2.device, dtype=torch.float32)
    sums = torch.empty(2 * D, device=x2.device, dtype=torch.float32)
    KERNEL.launch("layer_norm_backward", x2.data_ptr(), sf.data_ptr(),
                  mu.data_ptr(), rstd.data_ptr(), g2.data_ptr(),
                  dx.data_ptr(), part.data_ptr(), sums.data_ptr(), N, D,
                  _dtype_code_of(x2.dtype), P_, W, R, stream_ptr(x2))
    return dx, sums[:D], sums[D:]


class _LayerNorm(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x2, scale, bias, eps):
        sf, bf = (aligned(_as(t, torch.float32)) for t in (scale, bias))
        y, mu, rstd = _launch_forward(x2, sf, bf, eps)
        ctx.save_for_backward(x2, sf, mu, rstd)
        ctx.dtypes = (scale.dtype, bias.dtype)
        return y

    @staticmethod
    def backward(ctx, g):
        x2, sf, mu, rstd = ctx.saved_tensors
        dx, dscale, dbias = layer_norm_backward(
            x2, sf, mu, rstd, aligned(g.reshape(x2.shape).to(x2.dtype)))
        return (dx, dscale.to(ctx.dtypes[0]), dbias.to(ctx.dtypes[1]),
                None)


def fused_layer_norm(x: torch.Tensor, scale: torch.Tensor,
                     bias: torch.Tensor, eps: float = 1e-6) -> torch.Tensor:
    """LayerNorm over the last axis of x (any leading shape, float32 or
    bfloat16); scale and bias (D,) in any float dtype (used in float32,
    gradients returned in theirs). Returns y in x's dtype, differentiable
    in x, scale and bias.

    A CPU tensor takes :func:`layer_norm_plain`; a CUDA tensor takes the
    kernels.
    """
    if not x.is_cuda:
        return layer_norm_plain(x, scale, bias, eps)
    D = x.shape[-1]
    vec = 16 // x.element_size()
    if D % vec or D > MAX_D or scale.shape != (D,) or bias.shape != (D,):
        raise ValueError(f"fused_layer_norm: needs D % {vec} == 0, D <= "
                         f"{MAX_D} and (D,) parameters, got D={D}")
    x2 = aligned(x.reshape(-1, D))
    _dtype_code_of(x2.dtype)
    check_cuda_args("fused_layer_norm", (torch.float32, torch.bfloat16),
                    x=x2, scale=scale, bias=bias)
    if torch.is_grad_enabled() and any(
            t.requires_grad for t in (x, scale, bias)):
        y = _LayerNorm.apply(x2, scale, bias, eps)
    else:
        y = _launch_forward(x2, *(aligned(_as(t, torch.float32))
                                  for t in (scale, bias)), eps,
                            stats=False)[0]
    return y.reshape(x.shape)
