"""Relative-position multi-head attention CUDA kernel
(``csrc/relpos_attention.cu``).

Replaces ``speechain_tpu/ops/pallas_attention.py::flash_relpos_attention``
(forward ``pl.pallas_call`` at :722, body ``_rel_fwd_kernel`` :482): the
conformer encoder's Transformer-XL self-attention,

    s = (q+u) k^T + rel_shift((q+v) ph^T),  scaled, key-masked,
    out = softmax(s) v     (float32 softmax)

with q/k/v in their (B, T, D) projection layout (heads are column slices)
and the non-standard 1/sqrt(d_model) scale chosen by the caller.

What bounds it on the H100: at conformer-small (B = 16, T = 199, D = 256,
4 heads) each call is ~1.3 GFLOP of products on ~5 MB of q/k/v/out, so
the operations, and among them the (T, 2T-1) positional band, which is
as large as the content scores. The design keeps one (utterance, head)'s
whole key row, values and the band rows a 32-query tile touches in shared
memory, does the relative shift by index arithmetic on the band (no roll
and no (T, 2T-1) tensor in device memory), and folds the biases and the
scale into the (T, 64) query tile, as the TPU kernel does.
"""

from __future__ import annotations

from typing import Optional

import torch

from speechain_tpu_torch.ops.cuda_build import (SMEM_LIMIT, CudaKernel,
                                                F, I, P,
                                                check_cuda_args, stream_ptr)

KERNEL = CudaKernel(
    name="relpos_attention", source="relpos_attention.cu",
    symbols={"relpos_attention_forward": [P, P, P, P, P, P, P, P, I, I, I, I,
                                          F, I, P]},
    replaces={"relpos_attention_forward":
              "speechain_tpu/ops/pallas_attention.py:722"})

NEG_FILL = float(torch.finfo(torch.float32).min)
HEAD_DIM = 64             # csrc/relpos_attention.cu DH
TILE_Q = 32               # csrc/relpos_attention.cu TQ


def rel_shift(matrix_bd: torch.Tensor) -> torch.Tensor:
    """Transformer-XL relative shift (reference conformer/attention.py:26-46).

    matrix_bd: (B, H, T, 2T-1) scores against relative positions
    [T-1 .. -(T-1)]; returns (B, H, T, T) with
    out[..., i, j] = matrix_bd[..., i, j - i + T - 1].
    """
    B, H, T, L = matrix_bd.shape
    zero_pad = matrix_bd.new_zeros(B, H, T, 1)
    padded = torch.cat([zero_pad, matrix_bd], dim=-1).reshape(B, H, L + 1, T)
    return padded[:, :, 1:].reshape(B, H, T, L)[:, :, :, : L // 2 + 1]


def relpos_attention_plain(q, k, v, ph, bias_u, bias_v, scale: float,
                           num_heads: int,
                           key_mask: Optional[torch.Tensor] = None):
    """The kernel's function in plain PyTorch, same rounding points."""
    B, T, D = q.shape
    H, cd = num_heads, q.dtype
    Dh = D // H
    qf = q.float()
    qu = ((qf + bias_u.float().reshape(D)) * scale).to(cd).float()
    qv = ((qf + bias_v.float().reshape(D)) * scale).to(cd).float()

    def split(x):
        return x.reshape(B, T, H, Dh).transpose(1, 2)

    phh = ph.float().reshape(2 * T - 1, H, Dh).transpose(0, 1)    # (H, L, Dh)
    ac = split(qu) @ split(k.float()).transpose(-1, -2)
    bd = rel_shift(split(qv) @ phh.transpose(-1, -2)[None])
    s = ac + bd
    if key_mask is not None:
        s = s.masked_fill(~key_mask.bool()[:, None, None, :], NEG_FILL)
    p = torch.exp(s - s.amax(-1, keepdim=True))
    den = p.sum(-1, keepdim=True)
    o = (p.to(cd).float() @ split(v.float())) / den
    return o.transpose(1, 2).reshape(B, T, D).to(cd)


def cuda_relpos_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                          ph: torch.Tensor, bias_u: torch.Tensor,
                          bias_v: torch.Tensor, scale: float, num_heads: int,
                          key_mask: Optional[torch.Tensor] = None):
    """q/k/v (B, T, D) float32 or bfloat16; ph (2T-1, D) in q's dtype;
    bias_u/bias_v (D,) float32 (the (H, Dh) parameters flattened);
    key_mask (B, T) bool/int or None. Returns (B, T, D) in q's dtype.

    A CPU tensor takes :func:`relpos_attention_plain`; a CUDA tensor takes
    the kernel.
    """
    if not q.is_cuda:
        return relpos_attention_plain(q, k, v, ph, bias_u, bias_v, scale,
                                      num_heads, key_mask)
    B, T, D = q.shape
    cd = q.dtype
    if cd not in (torch.float32, torch.bfloat16):
        raise ValueError(f"cuda_relpos_attention: unsupported dtype {cd}")
    if D != num_heads * HEAD_DIM:
        raise ValueError(f"cuda_relpos_attention: head width {D // num_heads}"
                         f" != {HEAD_DIM}")
    if k.shape != q.shape or v.shape != q.shape or ph.shape != (2 * T - 1, D):
        raise ValueError("cuda_relpos_attention: q/k/v/ph shapes disagree")
    bu = bias_u.reshape(D)
    bv = bias_v.reshape(D)
    km = None
    if key_mask is not None:
        if key_mask.shape != (B, T):
            raise ValueError("cuda_relpos_attention: key_mask must be (B, T)")
        km = key_mask.to(torch.int32).contiguous()
    check_cuda_args("cuda_relpos_attention",
                    {"bu": (torch.float32,), "bv": (torch.float32,),
                     "km": (torch.int32,), "*": (cd,)},
                    q=q, k=k, v=v, ph=ph, bu=bu, bv=bv, km=km)
    rb = T + TILE_Q - 1
    smem = (4 * (2 * TILE_Q * HEAD_DIM + TILE_Q * rb + TILE_Q * T + TILE_Q)
            + q.element_size() * HEAD_DIM * (T + rb))
    if smem > SMEM_LIMIT:
        raise ValueError(f"cuda_relpos_attention: T={T} needs {smem} B of "
                         "shared memory")
    out = torch.empty_like(q)
    KERNEL.launch(
        "relpos_attention_forward", q.data_ptr(), k.data_ptr(), v.data_ptr(),
        ph.data_ptr(), bu.data_ptr(), bv.data_ptr(),
        None if km is None else km.data_ptr(), out.data_ptr(), B, T, D,
        num_heads, float(scale), 0 if cd == torch.float32 else 1,
        stream_ptr(q))
    return out
