"""Relative-position multi-head attention CUDA kernels, forward and backward
(``csrc/relpos_attention.cu``).

Replaces ``speechain_tpu/ops/pallas_attention.py::flash_relpos_attention``
(forward ``pl.pallas_call`` at :722, body ``_rel_fwd_kernel`` :482;
backward at :760, body ``_rel_bwd_kernel`` :555): the conformer encoder's
Transformer-XL self-attention,

    s = (q+u) k^T + rel_shift((q+v) ph^T),  scaled, key-masked,
    out = (round(exp(s - max) * dropmask) v) / sum exp(s - max)

with q/k/v in their (B, T, D) projection layout (heads are column slices)
and the non-standard 1/sqrt(d_model) scale chosen by the caller.

What bounds it on the H100: at conformer-small (B = 16, T = 199, D = 256,
4 heads) each forward is ~1 GFLOP of products on ~7 MB of q/k/v/ph/out,
1.0 us and 2.0 us at the card's peaks; the (T, 2T-1) positional band is
as large as the content scores. The design streams key tiles and the band
rows that each (query tile, key tile) pair touches through shared memory,
does the relative shift (and, in the backward, its transpose) by index
arithmetic (no roll and no (T, 2T-1) tensor in device memory), and folds
the biases and the scale into the (T, 64) query tile, as the TPU kernel
does. Shared memory does not grow with T, so there is no cap on T (the
JAX module routes T <= ``MAX_T`` = 768 to its kernel; the port takes any
T); device memory does grow with it, since the bf16 backward's dph
partials are B ceil(T / 64) 64 (ceil(T / 64) + 1) (D + H) float32 values
(``relpos_bwd_scratch``): about 21 MB at B 16, T 199, D 256, 117 MB at
T 600 and 1.1 GB at T 2000 (the float32 backward's are B (2T - 1) D).
The float32 forward and backward run on the FMA units (TF32 would break
the float32 contract); the bf16 forward runs its three products (content
scores, the position block, p v) on the tensor cores (``mma.sync``) in
tiles of ``TC_TILE`` rows, two sweeps over the key tiles for the exact
row maximum. The float32 backward is a dq pass per query tile, a dk/dv
pass per key tile and a dph pass per tile of band rows, with
per-utterance dph partials and per-tile dbu/dbv partials added in a fixed
order: no atomics. The bf16 backward runs every product on the tensor
cores (``mma.sync``): a dq pass per query tile that also forms that
tile's dph partials (the shift's transpose is a scatter into a band-layout
tile of dW), a dk/dv pass per key tile, and the band sums, over tiles of
``TC_TILE`` = 64 rows.

The forward rounds the UNNORMALISED p times the dropout mask (the TPU
forward's ``_softmax_fold``); the backward recomputes the NORMALISED
float32 softmax (``_softmax_fp32``), as the TPU backward does. Dropout
masks are ``ops/dropout.py::attention_mask``'s, bit for bit.
"""

from __future__ import annotations

import ctypes
from typing import Dict, Optional

import torch

from speechain_tpu_torch.ops import dropout as drop
from speechain_tpu_torch.ops.cuda_build import (CudaKernel, F, I, P, Q,
                                                U, aligned, check_cuda_args,
                                                stream_ptr)
from speechain_tpu_torch.ops.cuda_ffn import round_to

KERNEL = CudaKernel(
    name="relpos_attention", source="relpos_attention.cu",
    symbols={
        "relpos_attention_forward": [P, P, P, P, P, P, P, P, P, P, I, I, I,
                                     I, F, I, I, U, U, F, P],
        "relpos_attention_backward": [P] * 20 + [Q, Q, Q, I, I, I, I, F, I,
                                                 I, U, U, F, P]},
    replaces={
        "relpos_attention_forward":
            "speechain_tpu/ops/pallas_attention.py:722",
        "relpos_attention_backward":
            "speechain_tpu/ops/pallas_attention.py:760"})

NEG_FILL = float(torch.finfo(torch.float32).min)
TILE = 32                 # csrc/relpos_attention.cu TS (the float32 kernels)
# csrc/relpos_attention.cu, the bf16 backward on the tensor cores: query
# and key tiles of BT rows with rows of DH + 8 bf16 values; the band sums'
# rows a block (SUM_ROWS)
TC_TILE, SUM_ROWS = 64, 8


def tc_geometry() -> Dict[str, int]:
    """``Geo`` of the source: warps and threads of a block (BT / 16
    warps), the 2 BT band rows a tile pair touches, a warp's 16 x SBW
    float32 position scores, the dq pass's BT x LDW bf16 dW and the dk/dv
    pass's BT x LDP float32 position scores."""
    bt = TC_TILE
    return {"warps": bt // 16, "threads": 2 * bt, "band": 2 * bt,
            "sbw": bt + 20, "ldw": 2 * bt + 8, "ldp": bt + 4}


# csrc/relpos_attention.cu: the head widths its kernels are built at; a
# width up to 128 that is a multiple of 8 runs the next one up
RELPOS_HEAD_WIDTHS = (32, 64, 96, 128)
# csrc/flash_attention.cu: the same for the flash-attention kernels
FLASH_HEAD_WIDTHS = (32, 64, 96, 128, 192, 256)


def head_instance(name: str, dh: int, widths) -> int:
    """The built head width that runs head width ``dh``: the smallest of
    ``widths`` at least ``dh``, for a positive multiple of 8 up to the
    largest. Raises ValueError naming the width otherwise; ``name`` is the
    caller's, for the message."""
    if dh > 0 and dh % 8 == 0:
        for w in widths:
            if dh <= w:
                return w
    raise ValueError(f"{name}: head width {dh} is not supported by the "
                     f"CUDA kernels (a multiple of 8 up to {max(widths)})")


def relpos_kernel_smem(dtype: torch.dtype, dh: int = 64) -> Dict[str, int]:
    """Dynamic shared memory of each rel-pos kernel at head width ``dh``
    (run by the instance of width DH >= dh), as the source reckons it
    (``relpos_attention_smem`` returns the built kernels' own count; the
    smoke run holds the two equal). float32 keeps the FMA kernels
    (``FWD_SMEM``: five 32-row tiles and 64 band rows of float32 rows of
    DH + 1; ``DQ_SMEM``, ``DKDV_SMEM``, ``BAND_SMEM``); bf16 runs
    ``relpos_fwd_tc`` (``FWD_TC_SMEM``: qu and qv, two slots each of the
    k and v tiles and of the 2 BT band rows, rows of DH + 8 bf16; each
    warp's 16 x SBW float32 position scores; two slots of 8 bytes of key
    bits), ``relpos_bwd_dq_tc`` (five BT-row tiles and 2 BT band rows of
    DH + 8 bf16, the BT x LDW dW, each warp's 16 x SBW float32 position
    scores, 8 bytes of key bits) and ``relpos_bwd_dkdv_tc`` (the same
    tiles, BT x LDP float32 position scores, 3 x BT row statistics); its
    band sums take none."""
    w = head_instance("relpos_kernel_smem", dh, RELPOS_HEAD_WIDTHS)
    row = 4 * (w + 1)
    if dtype == torch.float32:
        return {"forward": (5 * TILE + 2 * TILE) * row,
                "dq": (6 * TILE + 2 * TILE) * row,
                "dkdv": (6 * TILE + 2 * TILE) * row + 4 * 3 * TILE,
                "band": (5 * TILE + 2 * 2 * TILE) * row + 4 * 3 * TILE}
    geo, bt = tc_geometry(), TC_TILE
    tiles = 2 * 7 * bt * (w + 8)
    position = 4 * geo["warps"] * 16 * geo["sbw"]
    return {"forward": 2 * (2 + 4 + 4) * bt * (w + 8) + position + 2 * 8,
            "dq": tiles + 2 * bt * geo["ldw"] + position + 8,
            "dkdv": tiles + 4 * bt * geo["ldp"] + 4 * 3 * bt,
            "band": 0}


def relpos_smem_bytes(T: int, dtype: torch.dtype = torch.float32,
                      dh: int = 64) -> int:
    """The largest dynamic shared memory of the kernels a call runs at head
    width ``dh`` in ``dtype`` (:func:`relpos_kernel_smem`), for sequences
    of T frames. Tiles stream, so T does not enter; a test holds it under
    the card's limit."""
    del T
    return max(relpos_kernel_smem(dtype, dh).values())


def relpos_bwd_scratch(B: int, T: int, D: int, H: int, dtype: torch.dtype
                       ) -> Dict[str, int]:
    """Float32 elements of the backward's three scratch buffers, as the
    source's ``scratch_need`` reckons them (the entry point refuses
    shorter buffers; ``relpos_attention_scratch`` returns its count, which
    the smoke run holds equal to this one). float32 (the FMA kernels):
    per-utterance dph partials (B, 2T - 1, D) and the dbu / dbv partials
    of each 32-row key / band tile. bf16 (the tensor cores, tiles of BT =
    64 rows, nk = ceil(T / BT)): the dq pass's
    dph partials of each query tile over its BT (nk + 1) band rows, (B,
    nk, BT (nk + 1), D), then their band-row sums of dW (B, nk, H, BT (nk
    + 1)); dbu partials (B nk, D); dbv partials of each SUM_ROWS band
    rows."""
    Lb = 2 * T - 1
    if dtype == torch.float32:
        return {"dph_part": B * Lb * D, "dbu_part": B * -(-T // TILE) * D,
                "dbv_part": B * -(-Lb // TILE) * D}
    nk = -(-T // TC_TILE)
    Lq = (nk + 1) * TC_TILE
    return {"dph_part": B * nk * Lq * (D + H), "dbu_part": B * nk * D,
            "dbv_part": -(-Lb // SUM_ROWS) * D}


def built_relpos_smem(dtype: torch.dtype, dh: int = 64) -> Dict[str, int]:
    """Shared memory each built rel-pos kernel takes at head width ``dh``,
    static plus dynamic, from the library
    (``relpos_attention_smem``): the count that
    :func:`relpos_kernel_smem` reckons without a card. Builds the
    kernels; needs a card."""
    w = head_instance("built_relpos_smem", dh, RELPOS_HEAD_WIDTHS)
    fn = KERNEL.lib.relpos_attention_smem
    fn.argtypes = [I, I, P]
    out = (ctypes.c_longlong * 4)()
    err = fn(0 if dtype == torch.float32 else 1, w, out)
    if err != 0:
        raise RuntimeError(f"relpos_attention_smem failed with cudaError "
                           f"{err}")
    return dict(zip(("forward", "dq", "dkdv", "band"), out))


def built_relpos_scratch(B: int, T: int, D: int, H: int,
                         dtype: torch.dtype) -> Dict[str, int]:
    """The scratch the built backward asks for a call
    (``relpos_attention_scratch``): the count that
    :func:`relpos_bwd_scratch` reckons without a card. Builds the kernels;
    needs a card."""
    fn = KERNEL.lib.relpos_attention_scratch
    fn.argtypes = [I, I, I, I, I, P]
    out = (ctypes.c_longlong * 3)()
    err = fn(0 if dtype == torch.float32 else 1, B, T, D, H, out)
    if err != 0:
        raise RuntimeError(f"relpos_attention_scratch failed with cudaError "
                           f"{err}")
    return dict(zip(("dph_part", "dbu_part", "dbv_part"), out))


# csrc/flash_attention.cu: the bf16 kernels' 64-row tiles staged with rows
# padded to DH + 8 bf16 values (BT, Tile<DH>::LDS), key and value tiles in
# a ring of two slots; the float32 kernels' 32-row tiles of float32 rows of
# DH + 1 (TS)
FLASH_TILE = 64
FLASH_FP32_TILE = 32


def flash_smem_bytes(Tk: int, dtype: torch.dtype, dh: int = 64
                     ) -> Dict[str, int]:
    """Shared memory of each flash-attention kernel for Tk keys at head
    width ``dh`` (run by the instance of width DH >= dh), as the source
    reckons it (``flash_attention_smem`` returns the built kernels' own
    count; the smoke run holds the two equal): in bf16 the dynamic shared
    memory of ``flash_fwd_tc`` (a q tile, two K and two V slots, 8 bytes
    of key-mask bits per key tile), ``flash_bwd_dq_tc`` (a g tile besides)
    and ``flash_bwd_dkdv_tc`` (k and v tiles, two slots of q and g tiles
    and of 64 row statistics M, L, D); in float32 the dynamic shared
    memory of the FMA kernels (4 or 5 staged tiles, and the dk/dv pass's
    3 row vectors)."""
    w = head_instance("flash_smem_bytes", dh, FLASH_HEAD_WIDTHS)
    if dtype == torch.float32:
        tile = 4 * FLASH_FP32_TILE * (w + 1)
        return {"forward": 4 * tile, "dq": 5 * tile,
                "dkdv": 5 * tile + 4 * 3 * FLASH_FP32_TILE}
    tile = 2 * FLASH_TILE * (w + 8)
    ntk = -(-Tk // FLASH_TILE)
    return {"forward": 5 * tile + 8 * ntk, "dq": 6 * tile + 8 * ntk,
            "dkdv": 6 * tile + 2 * 3 * FLASH_TILE * 4}


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


def relpos_scores_plain(q, k, ph, bias_u, bias_v, scale: float,
                        num_heads: int,
                        key_mask: Optional[torch.Tensor] = None):
    """The float32 scores (B, H, T, T) of :func:`relpos_attention_plain`:
    qu k^T + rel_shift(qv ph^T) with qu, qv rounded to q's dtype, masked
    keys finfo(float32).min (straight-through). Their row maximum and
    sum of exp(s - max) are what the forward kernel hands the backward
    as M and L."""
    B, T, D = q.shape
    H, cd = num_heads, q.dtype
    Dh = D // H
    qf = q.float()
    qu = round_to((qf + bias_u.float().reshape(D)) * scale, cd)
    qv = round_to((qf + bias_v.float().reshape(D)) * scale, cd)

    def split(x):
        return x.reshape(B, T, H, Dh).transpose(1, 2)

    phh = ph.float().reshape(2 * T - 1, H, Dh).transpose(0, 1)    # (H, L, Dh)
    ac = split(qu) @ split(k.float()).transpose(-1, -2)
    bd = rel_shift(split(qv) @ phh.transpose(-1, -2)[None])
    s = ac + bd
    if key_mask is not None:
        fill = ~key_mask.bool()[:, None, None, :]
        s = torch.where(fill, s + (NEG_FILL - s).detach(), s)
    return s


def relpos_attention_plain(q, k, v, ph, bias_u, bias_v, scale: float,
                           num_heads: int,
                           key_mask: Optional[torch.Tensor] = None,
                           rate: float = 0.0, seed: int = 0):
    """The kernels' function in plain PyTorch, same rounding points and
    dropout mask; its autograd is the backward kernel's reference (masked
    scores take the fill value straight-through, so a fully masked row
    passes the TPU kernel's gradient, as in
    ``cuda_flash_attention.flash_attention_plain``)."""
    B, T, D = q.shape
    H, cd = num_heads, q.dtype
    Dh = D // H
    s = relpos_scores_plain(q, k, ph, bias_u, bias_v, scale, num_heads,
                            key_mask)
    p = torch.exp(s - s.amax(-1, keepdim=True).detach())
    den = p.sum(-1, keepdim=True)
    if rate > 0.0:
        p = p * drop.attention_mask(B, H, T, T, rate, seed, q.device)
    v_h = v.float().reshape(B, T, H, Dh).transpose(1, 2)
    o = (round_to(p, cd) @ v_h) / den
    return o.transpose(1, 2).reshape(B, T, D).to(cd)


def _launch_forward(q, k, v, ph, bu, bv, km, scale, H, rate, seed):
    """The forward kernel; returns (out, row maximum, row denominator).
    float32 runs the FMA kernel, bf16 the tensor-core kernel; any other
    dtype raises."""
    B, T, D = q.shape
    if q.dtype not in (torch.float32, torch.bfloat16):
        raise ValueError(f"relpos_attention_forward: unsupported dtype "
                         f"{q.dtype}")
    out = torch.empty_like(q)
    M = torch.empty(B, H, T, device=q.device, dtype=torch.float32)
    L = torch.empty_like(M)
    KERNEL.launch(
        "relpos_attention_forward", q.data_ptr(), k.data_ptr(), v.data_ptr(),
        ph.data_ptr(), bu.data_ptr(), bv.data_ptr(),
        None if km is None else km.data_ptr(), out.data_ptr(), M.data_ptr(),
        L.data_ptr(), B, T, D, H, float(scale),
        0 if q.dtype == torch.float32 else 1, *drop.kernel_args(rate, seed),
        stream_ptr(q))
    return out, M, L


class _RelPos(torch.autograd.Function):
    """The forward kernel, with the backward kernel as its gradient."""

    @staticmethod
    def forward(ctx, q, k, v, ph, bu, bv, km, scale, H, rate, seed):
        out, M, L = _launch_forward(q, k, v, ph, bu, bv, km, scale, H, rate,
                                    seed)
        ctx.save_for_backward(q, k, v, ph, bu, bv, km, M, L)
        ctx.cfg = (scale, H, rate, seed)
        return out

    @staticmethod
    def backward(ctx, g):
        q, k, v, ph, bu, bv, km, M, L = ctx.saved_tensors
        dq, dk, dv, dph, dbu, dbv = relpos_attention_backward(
            q, k, v, ph, bu, bv, km, aligned(g), M, L, *ctx.cfg)
        return (dq, dk, dv, dph.to(ph.dtype), dbu, dbv,
                None, None, None, None, None)


def relpos_attention_backward(q, k, v, ph, bu, bv, km, g, M, L,
                              scale: float, H: int, rate: float, seed: int):
    """The backward kernel: (dq, dk, dv) in q's dtype and float32 (dph,
    dbu, dbv) for the output cotangent g, from the forward's row maximum M
    and denominator L (B, H, T); bf16 runs the tensor-core kernels."""
    B, T, D = q.shape
    Lb = 2 * T - 1
    check_cuda_args("relpos_attention_backward", (q.dtype,), g=g)
    dev, f32 = q.device, torch.float32
    dq, dk, dv = torch.empty_like(q), torch.empty_like(k), torch.empty_like(v)
    Dsum = torch.empty_like(M)
    sizes = relpos_bwd_scratch(B, T, D, H, q.dtype)
    dph_part, dbu_part, dbv_part = (
        torch.empty(n, device=dev, dtype=f32) for n in sizes.values())
    dph = torch.empty(Lb, D, device=dev, dtype=f32)
    dbu = torch.empty(D, device=dev, dtype=f32)
    dbv = torch.empty(D, device=dev, dtype=f32)
    KERNEL.launch(
        "relpos_attention_backward", q.data_ptr(), k.data_ptr(),
        v.data_ptr(), ph.data_ptr(), bu.data_ptr(), bv.data_ptr(),
        None if km is None else km.data_ptr(), g.data_ptr(), M.data_ptr(),
        L.data_ptr(), Dsum.data_ptr(), dq.data_ptr(), dk.data_ptr(),
        dv.data_ptr(), dph_part.data_ptr(), dbu_part.data_ptr(),
        dbv_part.data_ptr(), dph.data_ptr(), dbu.data_ptr(), dbv.data_ptr(),
        *sizes.values(), B, T, D, H, float(scale),
        0 if q.dtype == torch.float32 else 1, *drop.kernel_args(rate, seed),
        stream_ptr(q))
    return dq, dk, dv, dph, dbu, dbv


def cuda_relpos_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                          ph: torch.Tensor, bias_u: torch.Tensor,
                          bias_v: torch.Tensor, scale: float, num_heads: int,
                          key_mask: Optional[torch.Tensor] = None,
                          rate: float = 0.0, seed: int = 0):
    """q/k/v (B, T, D) float32 or bfloat16; ph (2T-1, D) in q's dtype;
    bias_u/bias_v (D,) float32 (the (H, Dh) parameters flattened);
    key_mask (B, T) bool/int or None; ``rate`` the attention dropout with
    int32 ``seed``. Returns (B, T, D) in q's dtype, differentiable in q, k,
    v, ph and the biases.

    A CPU tensor takes :func:`relpos_attention_plain`; a CUDA tensor takes
    the kernels, at a head width D / H that is a multiple of 8 up to 128
    (else ValueError).
    """
    if not q.is_cuda:
        return relpos_attention_plain(q, k, v, ph, bias_u, bias_v, scale,
                                      num_heads, key_mask, rate, seed)
    B, T, D = q.shape
    cd = q.dtype
    if cd not in (torch.float32, torch.bfloat16):
        raise ValueError(f"cuda_relpos_attention: unsupported dtype {cd}")
    if D % num_heads:
        raise ValueError("cuda_relpos_attention: d_model must be a multiple "
                         "of num_heads")
    head_instance("cuda_relpos_attention", D // num_heads,
                  RELPOS_HEAD_WIDTHS)
    if k.shape != q.shape or v.shape != q.shape or ph.shape != (2 * T - 1, D):
        raise ValueError("cuda_relpos_attention: q/k/v/ph shapes disagree")
    q, k, v, ph = (aligned(t) for t in (q, k, v, ph))   # 16-byte copies
    bu = bias_u.reshape(D).contiguous()
    bv = bias_v.reshape(D).contiguous()
    km = None
    if key_mask is not None:
        if key_mask.shape != (B, T):
            raise ValueError("cuda_relpos_attention: key_mask must be (B, T)")
        km = key_mask.to(torch.int32).contiguous()
    check_cuda_args("cuda_relpos_attention",
                    {"bu": (torch.float32,), "bv": (torch.float32,),
                     "km": (torch.int32,), "*": (cd,)},
                    q=q, k=k, v=v, ph=ph, bu=bu, bv=bv, km=km)
    args = (q, k, v, ph, bu, bv, km, float(scale), int(num_heads),
            float(rate), int(seed))
    if torch.is_grad_enabled() and any(
            t.requires_grad for t in (q, k, v, ph, bu, bv)):
        return _RelPos.apply(*args)
    return _launch_forward(*args)[0]             # no graph to record
