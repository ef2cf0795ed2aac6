"""Standard multi-head attention CUDA kernels, forward and backward
(``csrc/flash_attention.cu``).

Replaces ``speechain_tpu/ops/pallas_attention.py::flash_attention``: the
forward ``pl.pallas_call`` at :353 (body ``_std_fwd_kernel`` :250) and the
backward at :384 (body ``_std_bwd_kernel`` :271), used by the transformer
encoder's self-attention and the decoder's teacher-forced self- and
cross-attention:

    s = mask(q k^T * scale),  p = exp(s - max),  den = sum p,
    out = (round(p * dropmask) v) / den          (float32 softmax)

q (B, Tq, D), k/v (B, Tk, D) in their projection layout (head h is the
column slice [h * Dh, (h + 1) * Dh)); the caller's scale (1/sqrt(d_model)
by default, the reference's non-standard choice); a key mask (B, Tk); a
causal flag (Tq == Tk); masked scores are finfo(float32).min, so a fully
masked row averages uniformly instead of giving NaN.

What bounds it on the H100: the bytes at the path's shapes (at
transformer-wide training, B = 16, T = 199, 8 heads of 64, a bf16 forward
moves ~13 MB for ~1.3 GFLOP; the operations take over from T ~ 590). In
bf16 the products run on the tensor cores (``mma.sync``, operands staged by
``cp.async`` into a two-slot ring); float32 stays on the FMA units (TF32
would break the 1e-4 contract). The forward finds each row's exact maximum in a first
sweep over the keys so that p is rounded to the compute dtype at the TPU
kernel's point, saves the row maximum and denominator for the backward,
and the backward is a dq pass and a dk/dv pass over key tiles,
deterministic without atomics. Causal key tiles above a query tile's
diagonal are skipped unless a row of the tile is fully masked. The JAX
package caps T at ``MAX_T`` = 768 (its whole (T, T) problem had to fit
the TPU's VMEM); the kernels here stream key and query tiles and need no
cap.

The backward follows ``_std_bwd_kernel``: ds = p * (dp - rowsum(dp * p))
over every key, masked ones included, so a fully masked row passes the
same gradient to q and k as the TPU kernel does (where the XLA path's
``where`` would pass none). The plain version reproduces this with a
straight-through fill: the masked score takes the fill value but keeps
its gradient.
"""

from __future__ import annotations

import ctypes
from typing import Dict, Optional

import torch

from speechain_tpu_torch.ops import dropout as drop
from speechain_tpu_torch.ops.cuda_attention import (FLASH_HEAD_WIDTHS,
                                                    head_instance)
from speechain_tpu_torch.ops.cuda_build import (CudaKernel, F, I, P, U,
                                                aligned, check_cuda_args,
                                                stream_ptr)
from speechain_tpu_torch.ops.cuda_ffn import round_to

KERNEL = CudaKernel(
    name="flash_attention", source="flash_attention.cu",
    symbols={
        "flash_attention_forward": [P, P, P, P, P, P, P, I, I, I, I, I, F, I,
                                    I, I, U, U, F, P],
        "flash_attention_backward": [P, P, P, P, P, P, P, P, P, P, P, I, I,
                                     I, I, I, F, I, I, I, U, U, F, P]},
    replaces={
        "flash_attention_forward":
            "speechain_tpu/ops/pallas_attention.py:353",
        "flash_attention_backward":
            "speechain_tpu/ops/pallas_attention.py:384"})

NEG_FILL = float(torch.finfo(torch.float32).min)


def built_smem_bytes(Tk: int, dtype: torch.dtype, dh: int = 64
                     ) -> Dict[str, int]:
    """Shared memory each built kernel takes for Tk keys at head width
    ``dh``, static plus dynamic, from the library
    (``flash_attention_smem``): the count that
    ``ops/cuda_attention.py::flash_smem_bytes`` reckons without a card.
    Builds the kernels; needs a card."""
    w = head_instance("built_smem_bytes", dh, FLASH_HEAD_WIDTHS)
    fn = KERNEL.lib.flash_attention_smem
    fn.argtypes = [I, I, I, P]
    out = (ctypes.c_longlong * 3)()
    err = fn(int(Tk), 0 if dtype == torch.float32 else 1, w, out)
    if err != 0:
        raise RuntimeError(f"flash_attention_smem failed with cudaError "
                           f"{err}")
    return dict(zip(("forward", "dq", "dkdv"), out))


def pad_heads(x: torch.Tensor, num_heads: int, width: int) -> torch.Tensor:
    """(B, T, H * dh) -> (B, T, H * width): each head's columns followed by
    zeros up to ``width``, so that a head width between two instances runs
    the larger one (the zeros add nothing to q k^T, and the output's
    padded columns are p times zero)."""
    B, T, D = x.shape
    dh = D // num_heads
    return torch.nn.functional.pad(x.reshape(B, T, num_heads, dh),
                                   (0, width - dh)).reshape(
                                       B, T, num_heads * width)


def flash_attention_plain(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                          scale: float, num_heads: int, causal: bool = False,
                          rate: float = 0.0, seed: int = 0,
                          key_mask: Optional[torch.Tensor] = None
                          ) -> torch.Tensor:
    """The kernels' function in plain PyTorch, same rounding points and
    dropout mask; its autograd is the backward kernel's reference."""
    B, Tq, D = q.shape
    Tk = k.shape[1]
    H, cd = num_heads, q.dtype
    Dh = D // H

    def split(x, T):
        return x.float().reshape(B, T, H, Dh).transpose(1, 2)

    s = split(q, Tq) @ split(k, Tk).transpose(-1, -2) * scale
    fill = torch.zeros(B, 1, Tq, Tk, dtype=torch.bool, device=q.device)
    if key_mask is not None:
        fill = fill | ~key_mask.bool()[:, None, None, :]
    if causal:
        pos = torch.arange(Tk, device=q.device)
        fill = fill | (pos[None, :] > torch.arange(Tq, device=q.device)[:,
                                                                        None])
    s = torch.where(fill, s + (NEG_FILL - s).detach(), s)
    p = torch.exp(s - s.amax(-1, keepdim=True).detach())
    den = p.sum(-1, keepdim=True)
    if rate > 0.0:
        p = p * drop.attention_mask(B, H, Tq, Tk, rate, seed, q.device)
    o = (round_to(p, cd) @ split(v, Tk)) / den
    return o.transpose(1, 2).reshape(B, Tq, D).to(cd)


def _launch_forward(q, k, v, km, scale, H, causal, rate, seed):
    """The forward kernel; returns (out, row maximum, row denominator)."""
    B, Tq, D = q.shape
    Tk = k.shape[1]
    out = torch.empty_like(q)
    M = torch.empty(B, H, Tq, device=q.device, dtype=torch.float32)
    L = torch.empty_like(M)
    KERNEL.launch(
        "flash_attention_forward", q.data_ptr(), k.data_ptr(),
        v.data_ptr(), None if km is None else km.data_ptr(),
        out.data_ptr(), M.data_ptr(), L.data_ptr(), B, Tq, Tk, D, H,
        float(scale), int(causal), 0 if q.dtype == torch.float32 else 1,
        *drop.kernel_args(rate, seed), stream_ptr(q))
    return out, M, L


class _Flash(torch.autograd.Function):
    """The forward kernel, with the backward kernel as its gradient."""

    @staticmethod
    def forward(ctx, q, k, v, km, scale, H, causal, rate, seed):
        out, M, L = _launch_forward(q, k, v, km, scale, H, causal, rate,
                                    seed)
        ctx.save_for_backward(q, k, v, km, M, L)
        ctx.cfg = (scale, H, causal, rate, seed)
        return out

    @staticmethod
    def backward(ctx, g):
        q, k, v, km, M, L = ctx.saved_tensors
        return (*flash_attention_backward(q, k, v, km, aligned(g), M, L,
                                          *ctx.cfg),
                None, None, None, None, None, None)


def flash_attention_backward(q, k, v, km, g, M, L, scale: float, H: int,
                             causal: bool, rate: float, seed: int):
    """The backward kernel: (dq, dk, dv) for the output cotangent g, from
    the forward's row maximum M and denominator L (B, H, Tq)."""
    B, Tq, D = q.shape
    Tk = k.shape[1]
    check_cuda_args("flash_attention_backward", (q.dtype,), g=g)
    dq, dk, dv = torch.empty_like(q), torch.empty_like(k), torch.empty_like(v)
    Dsum = torch.empty_like(M)
    KERNEL.launch(
        "flash_attention_backward", q.data_ptr(), k.data_ptr(), v.data_ptr(),
        None if km is None else km.data_ptr(), g.data_ptr(), M.data_ptr(),
        L.data_ptr(), Dsum.data_ptr(), dq.data_ptr(), dk.data_ptr(),
        dv.data_ptr(), B, Tq, Tk, D, H, float(scale), int(causal),
        0 if q.dtype == torch.float32 else 1, *drop.kernel_args(rate, seed),
        stream_ptr(q))
    return dq, dk, dv


def flash_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                    scale: float, num_heads: int, causal: bool = False,
                    rate: float = 0.0, seed: int = 0,
                    key_mask: Optional[torch.Tensor] = None) -> torch.Tensor:
    """q (B, Tq, D), k/v (B, Tk, D) float32 or bfloat16; key_mask (B, Tk)
    bool/int or None; ``causal`` needs Tq == Tk; ``rate`` is the attention
    dropout with int32 ``seed``. Returns (B, Tq, D) in q's dtype,
    differentiable in q, k and v.

    A CPU tensor takes :func:`flash_attention_plain`; a CUDA tensor takes
    the kernels, at a head width D / num_heads that is a multiple of 8 up
    to 256 (else ValueError): the kernels are built at widths 32, 64, 96,
    128, 192 and 256, and a width between two runs the larger one on
    heads zero-padded by :func:`pad_heads`, its output sliced back.
    """
    B, Tq, D = q.shape
    Tk = k.shape[1]
    if causal and Tq != Tk:
        raise ValueError("flash_attention: causal attention must be square")
    if k.shape != (B, Tk, D) or v.shape != k.shape:
        raise ValueError("flash_attention: q/k/v shapes disagree")
    if key_mask is not None and tuple(key_mask.shape) != (B, Tk):
        raise ValueError("flash_attention: key_mask must be (B, Tk)")
    if not q.is_cuda:
        return flash_attention_plain(q, k, v, scale, num_heads, causal, rate,
                                     seed, key_mask)
    cd = q.dtype
    if cd not in (torch.float32, torch.bfloat16):
        raise ValueError(f"flash_attention: unsupported dtype {cd}")
    if D % num_heads:
        raise ValueError("flash_attention: d_model must be a multiple of "
                         "num_heads")
    dh = D // num_heads
    w = head_instance("flash_attention", dh, FLASH_HEAD_WIDTHS)
    if w != dh:
        out = flash_attention(*(pad_heads(x, num_heads, w) for x in (q, k, v)),
                              scale, num_heads, causal, rate, seed, key_mask)
        return out.reshape(B, Tq, num_heads, w)[..., :dh].reshape(B, Tq, D)
    q, k, v = aligned(q), aligned(k), aligned(v)      # 16-byte copies
    km = None if key_mask is None else key_mask.to(torch.int32).contiguous()
    check_cuda_args("flash_attention", {"km": (torch.int32,), "*": (cd,)},
                    q=q, k=k, v=v, km=km)
    args = (q, k, v, km, float(scale), int(num_heads), bool(causal),
            float(rate), int(seed))
    if torch.is_grad_enabled() and (q.requires_grad or k.requires_grad
                                    or v.requires_grad):
        return _Flash.apply(*args)
    return _launch_forward(*args)[0]             # no graph to record
