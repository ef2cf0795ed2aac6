"""Fused feed-forward CUDA kernel with residual epilogue (``csrc/ffn.cu``).

Replaces ``speechain_tpu/ops/pallas_ffn.py::fused_ffn`` (forward
``pl.pallas_call`` at :180) and ``::fused_ffn_residual`` (:264), which
share the body ``_fwd_kernel`` (:59):

    out = [res + alpha *] (act(x W1^T + b1) W2^T + b2)

What bounds it on the H100: at the encoder call (N = 16 x 199 rows,
D = 256, F = 1024) the operations (3.3 GFLOP against ~4 MB of traffic);
at the decode-step call (N = 256 rows) the bytes, mostly the 1 MB of
bf16 weights. The design keeps the (rows, F) intermediate in shared memory
(it never reaches device memory) and picks rows per block so that even
the 256-row decode call spreads over the card's SMs. The products run
on the FMA units in float32 with bf16 storage; tensor cores are later
work.

Rounding follows the TPU kernel: z rounded to the compute dtype before
the exact-erf GELU, h rounded to the compute dtype before the second
product, the residual add in float32.
"""

from __future__ import annotations

from typing import Optional

import torch
import torch.nn.functional as F

from speechain_tpu_torch.ops.cuda_build import (SMEM_LIMIT, CudaKernel,
                                                I, P,
                                                check_cuda_args, stream_ptr)
from speechain_tpu_torch.ops.cuda_build import F as CF

KERNEL = CudaKernel(
    name="ffn", source="ffn.cu",
    symbols={"ffn_forward": [P, P, P, P, P, P, P, I, I, I, I, I, I, CF, I,
                             P]},
    replaces="speechain_tpu/ops/pallas_ffn.py:264")

# torch.nn activation class name -> (plain version, kernel code in
# csrc/common.cuh::activate)
ACTIVATIONS = {
    "Identity": (lambda x: x, 0),
    "ReLU": (F.relu, 1),
    # exact erf GELU (torch.nn.GELU default), not the tanh approximation
    "GELU": (lambda x: F.gelu(x, approximate="none"), 2),
    "SiLU": (F.silu, 3),
    "Swish": (F.silu, 3),
    "Tanh": (torch.tanh, 4),
    "Sigmoid": (torch.sigmoid, 5),
    "ELU": (F.elu, 6),
    "LeakyReLU": (lambda x: F.leaky_relu(x, 0.01), 7),
    "Softplus": (F.softplus, 8),
    "Hardtanh": (lambda x: torch.clamp(x, -1.0, 1.0), 9),
}

_THREADS, _BK = 256, 32


def get_activation(name: str):
    if name not in ACTIVATIONS:
        raise KeyError(f"unknown activation {name!r}; known: "
                       f"{sorted(ACTIVATIONS)}")
    return ACTIVATIONS[name][0]


def ffn_plain(x: torch.Tensor, w1: torch.Tensor, b1: torch.Tensor,
              w2: torch.Tensor, b2: torch.Tensor, act: str = "GELU",
              residual: Optional[torch.Tensor] = None,
              alpha: float = 1.0) -> torch.Tensor:
    """The kernel's function in plain PyTorch, same rounding points."""
    cd = x.dtype
    z = x.float() @ w1.float().t() + b1.float()
    h = get_activation(act)(z.to(cd).float()).to(cd).float()
    y = h @ w2.float().t() + b2.float()
    if residual is not None:
        y = residual.float() + alpha * y
    return y.to(cd)


def _rows_per_block(N: int, device: torch.device) -> int:
    sms = torch.cuda.get_device_properties(device).multi_processor_count
    for r in (16, 8, 4, 2):
        if -(-N // r) >= sms:
            return r
    return 1


def cuda_ffn(x: torch.Tensor, w1: torch.Tensor, b1: torch.Tensor,
             w2: torch.Tensor, b2: torch.Tensor, act: str = "GELU",
             residual: Optional[torch.Tensor] = None,
             alpha: float = 1.0) -> torch.Tensor:
    """x (..., D) in float32 or bfloat16; w1 (F, D) and w2 (Do, F) in x's
    dtype; b1 (F,), b2 (Do,) float32; residual (..., Do) in x's dtype or
    None. Returns (..., Do) in x's dtype.

    A CPU tensor takes :func:`ffn_plain`; a CUDA tensor takes the kernel.
    """
    if not x.is_cuda:
        return ffn_plain(x, w1, b1, w2, b2, act, residual, alpha)
    lead = x.shape[:-1]
    D = x.shape[-1]
    Fd, Do = w1.shape[0], w2.shape[0]
    if w1.shape != (Fd, D) or w2.shape != (Do, Fd):
        raise ValueError(f"cuda_ffn: weights {tuple(w1.shape)}, "
                         f"{tuple(w2.shape)} do not fit x (..., {D})")
    if b1.shape != (Fd,) or b2.shape != (Do,):
        raise ValueError("cuda_ffn: bias shapes do not fit the weights")
    x2 = x.reshape(-1, D)
    N = x2.shape[0]
    r2 = None
    if residual is not None:
        if residual.shape != (*lead, Do):
            raise ValueError("cuda_ffn: residual shape does not fit")
        r2 = residual.reshape(N, Do)
    cd = x.dtype
    if cd not in (torch.float32, torch.bfloat16):
        raise ValueError(f"cuda_ffn: unsupported dtype {cd}")
    check_cuda_args("cuda_ffn", {"b1": (torch.float32,),
                                 "b2": (torch.float32,), "*": (cd,)},
                    x=x2, w1=w1, b1=b1, w2=w2, b2=b2, residual=r2)
    if act not in ACTIVATIONS:
        raise KeyError(f"unknown activation {act!r}")
    rows = _rows_per_block(N, x.device)
    smem = 4 * (rows * (D + Fd) + _THREADS * (_BK + 1))
    if smem > SMEM_LIMIT:
        raise ValueError(f"cuda_ffn: D={D}, F={Fd} need {smem} B of shared "
                         "memory")
    out = torch.empty(N, Do, device=x.device, dtype=cd)
    KERNEL.launch(
        "ffn_forward", x2.data_ptr(), w1.data_ptr(), b1.data_ptr(),
        w2.data_ptr(), b2.data_ptr(), None if r2 is None else r2.data_ptr(),
        out.data_ptr(), N, D, Fd, Do, rows, ACTIVATIONS[act][1],
        float(alpha), 0 if cd == torch.float32 else 1, stream_ptr(x))
    return out.reshape(*lead, Do)
