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

What bounds it on the H100: the bytes. At the conformer encoder's N =
3184 rows of D = 256 in bf16 the forward moves 3.29 MB (x read, y
written, mu/rstd written: 0.98 us at 3.35 TB/s), the backward ~4.9 MB
(1.47 us): both far below a launch's latency. The forward gives each row
one warp, 16-byte loads and a shuffle reduction of the float32 sum and sum
of squares, and reads the row again (from L1) for y. The backward gives
each row one warp too; the parameter gradients, which the TPU kernel
accumulates over a sequential grid of 512-row blocks, are per-block
partials (16 rows a block) added in a fixed order by a second kernel:
deterministic, no atomics.

Off by default, as in the JAX package (:37-53): ``SPEECHAIN_FORCE_FUSED_LN``
turns it on and ``SPEECHAIN_DISABLE_PALLAS`` keeps it off even then (the
reference's code checks the disable first, whatever its comment says);
``nn/norms.py::LayerNorm`` takes the route only where the reference's gate
does.
"""

from __future__ import annotations

import os

import torch

from speechain_tpu_torch.ops.cuda_build import (CudaKernel, F, I, P, aligned,
                                                check_cuda_args, stream_ptr)
from speechain_tpu_torch.ops.cuda_ffn import _as

KERNEL = CudaKernel(
    name="layernorm", source="layernorm.cu",
    symbols={"layer_norm_forward": [P, P, P, P, P, P, I, I, F, I, P],
             "layer_norm_backward": [P, P, P, P, P, P, P, P, I, I, I, P]},
    replaces={"layer_norm_forward":
              "speechain_tpu/ops/pallas_layernorm.py:117",
              "layer_norm_backward":
              "speechain_tpu/ops/pallas_layernorm.py:139"})

ROWS_PER_BLOCK = 8        # csrc/layernorm.cu: forward, one warp a row
BWD_ROWS_PER_BLOCK = 16   # csrc/layernorm.cu: backward, two rows a warp
MAX_D = 1024              # csrc/layernorm.cu: a lane keeps 32 columns


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


def _dtype_code(x: torch.Tensor) -> int:
    if x.dtype not in (torch.float32, torch.bfloat16):
        raise ValueError(f"fused_layer_norm: unsupported dtype {x.dtype}")
    return 0 if x.dtype == torch.float32 else 1


def _launch_forward(x2, sf, bf, eps):
    N, D = x2.shape
    y = torch.empty_like(x2)
    mu = torch.empty(N, device=x2.device, dtype=torch.float32)
    rstd = torch.empty(N, device=x2.device, dtype=torch.float32)
    KERNEL.launch("layer_norm_forward", x2.data_ptr(), sf.data_ptr(),
                  bf.data_ptr(), y.data_ptr(), mu.data_ptr(),
                  rstd.data_ptr(), N, D, float(eps), _dtype_code(x2),
                  stream_ptr(x2))
    return y, mu, rstd


def layer_norm_backward(x2, sf, mu, rstd, g2):
    """The backward kernel: (dx (N, D) in x's dtype, dscale (D,) and dbias
    (D,) float32) for the cotangent g2 (N, D) in x's dtype."""
    N, D = x2.shape
    check_cuda_args("layer_norm_backward",
                    {"x": (x2.dtype,), "g": (x2.dtype,),
                     "*": (torch.float32,)},
                    x=x2, scale=sf, mu=mu, rstd=rstd, g=g2)
    blocks = -(-N // BWD_ROWS_PER_BLOCK)
    dx = torch.empty_like(x2)
    part = torch.empty(blocks, 2 * D, device=x2.device, dtype=torch.float32)
    sums = torch.empty(2 * D, device=x2.device, dtype=torch.float32)
    KERNEL.launch("layer_norm_backward", x2.data_ptr(), sf.data_ptr(),
                  mu.data_ptr(), rstd.data_ptr(), g2.data_ptr(),
                  dx.data_ptr(), part.data_ptr(), sums.data_ptr(), N, D,
                  _dtype_code(x2), stream_ptr(x2))
    return dx, sums[:D], sums[D:]


class _LayerNorm(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x2, scale, bias, eps):
        sf, bf = _as(scale, torch.float32), _as(bias, torch.float32)
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
    _dtype_code(x2)
    check_cuda_args("fused_layer_norm", (torch.float32, torch.bfloat16),
                    x=x2, scale=scale, bias=bias)
    if torch.is_grad_enabled() and any(
            t.requires_grad for t in (x, scale, bias)):
        y = _LayerNorm.apply(x2, scale, bias, eps)
    else:
        y = _launch_forward(x2, _as(scale, torch.float32),
                            _as(bias, torch.float32), eps)[0]
    return y.reshape(x.shape)
