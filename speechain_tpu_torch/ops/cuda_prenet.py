"""The fused Conv2d-prenet core as CUDA kernels, forward and backward
(``csrc/prenet.cu``), with the reference's XLA core and the patch
statistics both cores share.

Replaces ``speechain_tpu/ops/pallas_prenet.py::fused_prenet_core``
(forward ``pl.pallas_call`` at :492, body ``_fwd_kernel`` :278; backward
at :536, body ``_bwd_kernel`` :320):

    out = conv2(act(g1 * conv1(mel) + b1))      pre-BN2, (B, T2, F2, C)

conv1 3x3 stride 2 from one channel to C (w1 (9, C), no bias), the
BatchNorm-1 affine (g1, b1) and the activation applied in the same pass,
conv2 3x3 stride 2 from C to C (w2 (9, C, C), taps major, then input
channel), both VALID. Rounding points (``pallas_prenet.py:269-316``): mel
in the compute dtype, w1 rounded to it before conv1, z * g1 + b1 in
float32, h = act(.) rounded to the compute dtype, w2 rounded, float32
sums, the output in the compute dtype. The backward returns dw2, dw1 =
A g1 with A = sum patch^T dy (patch and dy rounded, ``:374``), dg1 =
sum dy z and db1 = sum dy, and ZERO for the mel: the ASR frontend
upstream has no parameters (``:404-426``). The BatchNorm-1 moments come
analytically from the patch statistics outside the core
(:func:`patch_stats_std`, as differentiable functions of w1), so autograd
carries dg1 and db1 back to w1 and the BatchNorm parameters
(``nn/prenets.py::Conv2dPrenet``). :func:`xla_prenet_core` is the exact
route (input gradients included).

What bounds it on the H100: the operations. At conformer-small (16 x 8 s:
mel (16, 801, 80), C = 256) conv2 is 60,496 output positions x 9 x 256^2
multiply-adds, 71.4 GFLOP (0.072 ms at bf16's 989 TFLOP/s, 1.07 ms at
float32's 67), conv1 ~1.2 GFLOP more; the backward ~145 GFLOP. The TPU
kernel's phase-split 16-lane patch matrix, 8-row halos and sequential-grid
read-modify-write sums exist for Mosaic's tiling and are not carried
over. The forward takes the mel itself (no patch matrix in device memory)
and treats conv2 as an implicit product: a block owns 64 output channels
of a few output rows, stages their mel rows once, and for each 16 input
channels recomputes conv1 + affine + activation for the conv1 rows it
reads (9 multiply-adds per value against conv2's 9 x 64) in shared memory,
never writing the (16, 400, 39, 256) activation to device memory. The
backward recomputes h and z from the mel too: one kernel walks the conv1
positions by stride phase (so every position of a tile has the same conv2
taps reading it) forming dh = conv2^T(du) and dy, and sums A, dy and dy z;
one kernel forms dw2 per tap as a product over the 60,496 output
positions split across many blocks; per-block partials are added in a
fixed order (no atomics). In float32 the products run on the FMA units.
In bf16 every product runs on the tensor cores (``mma.sync``, float32
sums), conv1's too, as the reference runs it on its matrix unit (the 9
taps zero-padded to 16 lanes): 128-position forward tiles over the
reference's four stride-phase planes of h, and w2 / du tiles copied
straight from their own layouts by ``cp.async`` into three-stage rings,
read by ``ldmatrix`` (``.trans`` where the layout asks); the shared memory
and grids are reckoned here (:func:`tc_smem_bytes`, :func:`tc_grids`) and
held equal to the built kernels' on the card (:func:`built_layout`).
"""

from __future__ import annotations

import ctypes
import os
from typing import Optional

import torch
import torch.nn.functional as F

from speechain_tpu_torch.ops.cuda_build import (CudaKernel, I, P, aligned,
                                                check_cuda_args, stream_ptr)
from speechain_tpu_torch.ops.cuda_ffn import (ACTIVATIONS, _as, _sm_count,
                                              get_activation, round_to)

KERNEL = CudaKernel(
    name="prenet", source="prenet.cu",
    symbols={"prenet_core_forward": [P] * 6 + [I] * 6 + [P],
             "prenet_core_backward": [P] * 10 + [I] * 8 + [P]},
    replaces={"prenet_core_forward":
              "speechain_tpu/ops/pallas_prenet.py:492",
              "prenet_core_backward":
              "speechain_tpu/ops/pallas_prenet.py:536"})

TILE = 64           # csrc/prenet.cu: float32 block tile rows; the most F2
CHANNELS = 64       # csrc/prenet.cu CO: channels of a float32 block tile
# csrc/prenet.cu, the bf16 kernels: the rings' depth (STAGES); the
# forward's tile rows (TM) and output rows (at most RTMAX), output
# channels a forward or dw2 block owns (NB), input channels of an h chunk
# (CKF), the bf16 row strides of its h planes (HSF) and of a w2 / du tile
# over NB channels (WSF); the dy pass's conv1 positions an item (TQ),
# input channels a block (NQ), reduction depth a step (KQ), its tiles'
# row stride (DS); the dw2 pass's input channels a block (MW), positions
# a step (KP), its h tile's stride (HSW)
STAGES, TM, RTMAX, NB, CKF, HSF, WSF = 3, 128, 32, 256, 64, 72, 264
TQ, NQ, KQ, DS = 128, 128, 128, 136
MW, KP, HSW = 128, 64, 136
NSUM = 11           # dy pass sums per channel: A (9), sum dy, sum dy z
S2_MAX = 8          # dw2 partials at most (16.5 MB at C 256)
SMS = 132           # streaming multiprocessors of the H100 SXM: the split
                    # reckoning without a card; a launch takes the card's


def sm_count(device: torch.device) -> int:
    """Streaming multiprocessors of the card ``device`` names (SMS for
    the CPU), on which the bf16 backward's split counts depend."""
    return _sm_count(device) if device.type == "cuda" else SMS


def prenet_core_impl() -> Optional[str]:
    """The reference's route switch (``pallas_prenet.py:86-126``): None
    (the unfused prenet), ``"xla"`` or ``"fused"`` (the reference's
    ``"pallas"``: this module's CUDA core). ``SPEECHAIN_DISABLE_FUSED_PRENET``
    wins; ``SPEECHAIN_FORCE_FUSED_PRENET`` = 1 / true / pallas selects the
    kernel core, demoted to ``"xla"`` under ``SPEECHAIN_DISABLE_PALLAS``;
    = xla selects the XLA core."""
    if os.environ.get("SPEECHAIN_DISABLE_FUSED_PRENET"):
        return None
    force = os.environ.get("SPEECHAIN_FORCE_FUSED_PRENET", "").lower()
    if force in ("1", "true", "pallas"):
        return "xla" if os.environ.get("SPEECHAIN_DISABLE_PALLAS") else \
            "fused"
    return "xla" if force == "xla" else None


def geom(T: int, F: int):
    """VALID stride-2 kernel-3 twice: conv1 (U1, F1), conv2 (T2, F2). (The
    reference also returns its phase planes' sizes, which the port's
    kernels do not use.)"""
    U1, F1 = (T - 3) // 2 + 1, (F - 3) // 2 + 1
    return U1, F1, (U1 - 3) // 2 + 1, (F1 - 3) // 2 + 1


def build_patches_std(mel: torch.Tensor,
                      dtype: Optional[torch.dtype] = None) -> torch.Tensor:
    """(B, T, F) -> (B, U1, F1, 9) conv1 im2col in the standard layout,
    M[b, u, v, 3 a + c] = mel[b, 2 u + a, 2 v + c], in ``dtype`` (default
    mel's): every row a valid conv1 position."""
    B, T, F = mel.shape
    U1, F1, _, _ = geom(T, F)
    taps = [mel[:, a:a + 2 * U1 - 1:2, c:c + 2 * F1 - 1:2]
            for a in range(3) for c in range(3)]
    return torch.stack(taps, dim=-1).to(dtype or mel.dtype)


def patch_stats_std(M: torch.Tensor):
    """S (9,) and G (9, 9) float32 over every position of the patch matrix:
    the sufficient statistics of conv1's BatchNorm batch moments."""
    Mf = M.reshape(-1, M.shape[-1]).float()
    return Mf.sum(0), Mf.t() @ Mf


def xla_prenet_core(M: torch.Tensor, w1: torch.Tensor, g1: torch.Tensor,
                    b1: torch.Tensor, w2: torch.Tensor,
                    act_name: str) -> torch.Tensor:
    """The reference's default fused route (``pallas_prenet.py::
    xla_prenet_core``) in plain PyTorch: BatchNorm-1 folded into the conv1
    weights, act(M (w1 g1) + b1) as one product, conv2 by ``F.conv2d`` in
    the compute dtype; plain autograd, so every gradient (the input's
    too) is exact.

    M (B, U1, F1, 9) patches in the compute dtype; w1 (9, C), g1 / b1 (C,)
    float32; w2 (9, C, C) taps major. Returns (B, T2, F2, C) pre-BN2 in
    M's dtype."""
    cd = M.dtype
    B, U1, F1, K = M.shape
    C = w1.shape[1]
    w1g = round_to(w1.float() * g1.float().reshape(1, C), cd)
    z = M.reshape(-1, K).float() @ w1g
    h = get_activation(act_name)(z + b1.float()).to(cd)
    h = h.reshape(B, U1, F1, C).permute(0, 3, 1, 2)
    w2o = w2.reshape(3, 3, C, C).permute(3, 2, 0, 1).to(cd)
    return F.conv2d(h, w2o, stride=2).permute(0, 2, 3, 1)


def conv1_preact(mel: torch.Tensor, w1: torch.Tensor, g1: torch.Tensor,
                 b1: torch.Tensor):
    """(z, y) float32 (B, U1, F1, C): conv1 of the compute-dtype mel with
    w1 rounded to that dtype, summed over the taps in order with each
    product and each sum rounded to float32 (no fused multiply-add), and
    y = z g1 + b1 likewise: the kernels' exact arithmetic, so on the card
    this gives the kernels' own pre-activations bit for bit."""
    cd = mel.dtype
    Mp = build_patches_std(mel).float()
    w1c = round_to(w1.float(), cd)
    z = Mp[..., 0, None] * w1c[0]
    for j in range(1, 9):
        z = z + Mp[..., j, None] * w1c[j]
    return z, z * g1.float() + b1.float()


def prenet_core_plain(mel: torch.Tensor, w1: torch.Tensor, g1: torch.Tensor,
                      b1: torch.Tensor, w2: torch.Tensor,
                      act_name: str) -> torch.Tensor:
    """The kernels' function in plain PyTorch, same rounding points; its
    autograd (in w1, g1, b1, w2) is the backward kernel's reference.

    mel (B, T, F) in the compute dtype; w1 (9, C), g1 / b1 (C,), w2
    (9, C, C) in any float dtype. Returns (B, T2, F2, C) in mel's dtype."""
    cd = mel.dtype
    _, T, Fm = mel.shape
    _, _, T2, F2 = geom(T, Fm)
    _, y = conv1_preact(mel, w1, g1, b1)
    h = round_to(get_activation(act_name)(y), cd)
    w2c = round_to(w2.float(), cd)
    out = None
    for t in range(9):
        dt, df = divmod(t, 3)
        term = h[:, dt:dt + 2 * T2 - 1:2, df:df + 2 * F2 - 1:2] @ w2c[t]
        out = term if out is None else out + term
    return out.to(cd)


def _dtype_code(mel: torch.Tensor) -> int:
    if mel.dtype not in (torch.float32, torch.bfloat16):
        raise ValueError(f"fused_prenet_core: unsupported dtype {mel.dtype}")
    return 0 if mel.dtype == torch.float32 else 1


def _check_shapes(mel, w1, g1, b1, w2):
    """The shapes the kernels take, those ``Conv2dPrenet.fused_route``
    admits: C a multiple of 128, T2 >= 2 and 1 <= F2 <= 64."""
    B, T, Fm = mel.shape
    C = w1.shape[-1]
    _, _, T2, F2 = geom(T, Fm)
    if (w1.shape != (9, C) or g1.shape != (C,) or b1.shape != (C,)
            or w2.shape != (9, C, C)):
        raise ValueError("fused_prenet_core: parameter shapes do not fit")
    if C % NQ or T2 < 2 or not 1 <= F2 <= TILE:
        raise ValueError(f"fused_prenet_core: needs C % {NQ} == 0, "
                         f"1 <= F2 <= {TILE} and T2 >= 2; got C={C}, "
                         f"T2={T2}, F2={F2}")


def _launch_forward(mel, w1c, g1f, b1f, w2c, act_name):
    w2c = aligned(w2c)                 # read 16 bytes at a time
    B, T, Fm = mel.shape
    C = w1c.shape[1]
    _, _, T2, F2 = geom(T, Fm)
    out = torch.empty(B, T2, F2, C, device=mel.device, dtype=mel.dtype)
    KERNEL.launch("prenet_core_forward", mel.data_ptr(), w1c.data_ptr(),
                  g1f.data_ptr(), b1f.data_ptr(), w2c.data_ptr(),
                  out.data_ptr(), B, T, Fm, C, ACTIVATIONS[act_name][1],
                  _dtype_code(mel), stream_ptr(mel))
    return out


def backward_splits(B: int, T: int, F: int, C: int,
                    dtype: torch.dtype = torch.bfloat16, sms: int = SMS):
    """(S1, S2): blocks sharing the conv1 positions in the dy pass and
    the output positions in the dw2 pass; enough blocks to fill the card,
    few enough partial sums to add cheaply. float32: dy blocks of 64
    channels, dw2 per tap and 64 x 64 tile of dw2, up to 32 splits. bf16
    (one block an SM): dy blocks of NQ channels over ``sms`` blocks; dw2
    per tap, MW input and NB output channels, the split count up to
    S2_MAX whose waves of ``sms`` blocks take the least time (7 splits at
    C 256 on 132 SMs: one wave of 126 blocks)."""
    U1, F1, T2, F2 = geom(T, F)
    if dtype == torch.float32:
        nt = C // CHANNELS
        items = B * 4 * -(-((U1 + 1) // 2) * ((F1 + 1) // 2) // TILE)
        s1 = max(1, min(items, 1024 // nt))
        s2 = max(1, min(32, 1152 // (9 * nt * -(-C // 256)),
                        -(-B * T2 * F2 // 64)))
        return s1, s2
    items = B * 4 * dy_tiles(U1, F1)
    s1 = max(1, min(items, sms // (C // NQ)))
    per_split = 9 * (C // MW) * -(-C // NB)
    steps = -(-B * T2 * F2 // KP)
    s2 = min(range(1, max(1, min(S2_MAX, steps)) + 1),
             key=lambda s: -(-s * per_split // sms) / s)
    return s1, s2


def dy_tiles(U1: int, F1: int) -> int:
    """Tiles of TQ conv1 positions of the largest stride phase (t1, f1
    both even): the bf16 dy pass's items a phase and utterance."""
    return -(-((U1 + 1) // 2) * ((F1 + 1) // 2) // TQ)


def fwd_rows(F2: int) -> int:
    """Output rows of a bf16 forward block: TM // F2 (114 positions at
    F2 19), at most RTMAX."""
    return min(TM // F2, RTMAX)


def tc_smem_bytes(T: int, F: int) -> dict:
    """Shared memory, static plus dynamic, of each bf16 kernel at a mel
    of (T, F), as ``csrc/prenet.cu`` lays it out: the forward's ring of
    STAGES CKF x WSF w2 tiles, its four h planes (RT + 1 rows of F2 + 1,
    rounded up to whole 16-row tiles, HSF a row) and its 4 RT + 3 mel rows
    (rounded to 16 bytes); the dy pass's ring of (TQ + NQ) x DS tiles,
    g1 / b1 and the two running column sums of 4 row warps for NQ
    channels; the dw2 pass's ring of KP x WSF du tiles, two KP x HSW h
    tiles and g1 / b1 for MW channels. bf16 tiles, float32 g1 / b1 and
    sums."""
    _, _, _, F2 = geom(T, F)
    RT = fwd_rows(F2)
    h_rows = -(-4 * (RT + 1) * (F2 + 1) // 16) * 16
    mel = -(-(4 * RT + 3) * F // 8) * 8
    return {"fwd": 2 * (STAGES * CKF * WSF + h_rows * HSF + mel),
            "dy": 2 * STAGES * (TQ + NQ) * DS + (2 + 4 * 2) * NQ * 4,
            "dw2": 2 * (STAGES * KP * WSF + 2 * KP * HSW) + 2 * MW * 4}


def tc_grids(B: int, T: int, F: int, C: int, sms: int = SMS) -> dict:
    """Blocks (x, y, z) of each bf16 launch: the forward (row tiles of
    ``fwd_rows``, NB-channel tiles, utterances), the dy pass (S1, NQ
    channel tiles) and the dw2 pass (S2, MW x NB channel tiles, taps)."""
    _, _, T2, F2 = geom(T, F)
    RT = fwd_rows(F2)
    s1, s2 = backward_splits(B, T, F, C, torch.bfloat16, sms)
    return {"fwd": (-(-T2 // RT), -(-C // NB), B),
            "dy": (s1, C // NQ, 1),
            "dw2": (s2, (C // MW) * -(-C // NB), 9)}


def built_layout(B: int, T: int, F: int, C: int) -> dict:
    """The built bf16 kernels' shared memory (static plus dynamic) and
    grids for a call (``prenet_layout``): what :func:`tc_smem_bytes` and
    :func:`tc_grids` reckon without a card. Builds the kernels; needs a
    card."""
    fn = KERNEL.lib.prenet_layout
    fn.argtypes = [I] * 6 + [P]
    out = (ctypes.c_longlong * 12)()
    sms = sm_count(torch.device("cuda", torch.cuda.current_device()))
    s1, s2 = backward_splits(B, T, F, C, torch.bfloat16, sms)
    err = fn(B, T, F, C, s1, s2, out)
    if err != 0:
        raise RuntimeError(f"prenet_layout failed with cudaError {err}")
    kinds = ("fwd", "dy", "dw2")
    return {"smem": dict(zip(kinds, out[0:3])),
            "grids": {k: tuple(out[3 + 3 * i:6 + 3 * i])
                      for i, k in enumerate(kinds)}}


def prenet_core_backward(mel, w1c, g1f, b1f, w2c, du, act_name):
    """The backward kernels: (dw2 (9, C, C), A (9, C), sum dy (C,),
    sum dy z (C,)), all float32, for the cotangent du (B, T2, F2, C) in
    mel's dtype."""
    w2c, du = aligned(w2c), aligned(du)    # read 16 bytes at a time
    B, T, Fm = mel.shape
    C = w1c.shape[1]
    cd = mel.dtype
    check_cuda_args("prenet_core_backward",
                    {"g1": (torch.float32,), "b1": (torch.float32,),
                     "*": (cd,)},
                    mel=mel, w1=w1c, g1=g1f, b1=b1f, w2=w2c, du=du)
    s1, s2 = backward_splits(B, T, Fm, C, cd, sm_count(mel.device))
    dev, f32 = mel.device, torch.float32
    dw2 = torch.empty(9, C, C, device=dev, dtype=f32)
    sums = torch.empty(NSUM * C, device=dev, dtype=f32)
    part1 = torch.empty(s1, NSUM * C, device=dev, dtype=f32)
    part2 = torch.empty(s2, 9 * C * C, device=dev, dtype=f32)
    KERNEL.launch("prenet_core_backward", mel.data_ptr(), w1c.data_ptr(),
                  g1f.data_ptr(), b1f.data_ptr(), w2c.data_ptr(),
                  du.data_ptr(), dw2.data_ptr(), sums.data_ptr(),
                  part1.data_ptr(), part2.data_ptr(), B, T, Fm, C,
                  ACTIVATIONS[act_name][1], _dtype_code(mel), s1, s2,
                  stream_ptr(mel))
    return dw2, sums[:9 * C].reshape(9, C), sums[9 * C:10 * C], \
        sums[10 * C:]


def _kernel_params(cd, w1, g1, b1, w2):
    return (_as(w1, cd), _as(g1, torch.float32), _as(b1, torch.float32),
            _as(w2, cd))


class _PrenetCore(torch.autograd.Function):
    """The core with its backward: the kernels for a CUDA tensor, autograd
    of the plain version for a CPU tensor; the mel's gradient is zero on
    both (see the module docstring)."""

    @staticmethod
    def forward(ctx, mel, w1, g1, b1, w2, act_name):
        ctx.act = act_name
        ctx.dtypes = (w1.dtype, g1.dtype, b1.dtype, w2.dtype)
        if mel.is_cuda:
            kp = _kernel_params(mel.dtype, w1, g1, b1, w2)
            ctx.save_for_backward(mel, *kp)
            return _launch_forward(mel, *kp, act_name)
        params = [t.detach().requires_grad_() for t in (w1, g1, b1, w2)]
        with torch.enable_grad():
            out = prenet_core_plain(mel.detach(), *params, act_name)
        ctx.plain = (out, params)
        ctx.mel_like = (mel.shape, mel.dtype)
        return out.detach()

    @staticmethod
    def backward(ctx, g):
        if hasattr(ctx, "plain"):
            out, params = ctx.plain
            del ctx.plain
            grads = torch.autograd.grad(out, params, g)
            shape, dtype = ctx.mel_like
        else:
            mel, w1c, g1f, b1f, w2c = ctx.saved_tensors
            dw2, A, sdy, sdyz = prenet_core_backward(
                mel, w1c, g1f, b1f, w2c, g.to(mel.dtype), ctx.act)
            grads = (A * g1f, sdyz, sdy, dw2)
            shape, dtype = mel.shape, mel.dtype
        dmel = (torch.zeros(shape, dtype=dtype, device=g.device)
                if ctx.needs_input_grad[0] else None)
        return (dmel, *(gr.to(dt) for gr, dt in zip(grads, ctx.dtypes)),
                None)


def fused_prenet_core(mel: torch.Tensor, w1: torch.Tensor, g1: torch.Tensor,
                      b1: torch.Tensor, w2: torch.Tensor,
                      act_name: str) -> torch.Tensor:
    """conv2(act(g1 conv1(mel) + b1)), pre-BN2, as the module docstring
    says. mel (B, T, F) float32 or bfloat16 (the compute dtype); w1 (9, C),
    g1 / b1 (C,), w2 (9, C, C) in any float dtype (w1, w2 rounded to the
    compute dtype at use; gradients returned in their dtypes). Returns
    (B, T2, F2, C) in mel's dtype, differentiable in the parameters; the
    mel's gradient is zero by design.

    A CPU tensor takes :func:`prenet_core_plain`; a CUDA tensor takes the
    kernels.
    """
    needs_grad = torch.is_grad_enabled() and any(
        t.requires_grad for t in (mel, w1, g1, b1, w2))
    if not mel.is_cuda:
        if needs_grad:
            return _PrenetCore.apply(mel, w1, g1, b1, w2, act_name)
        return prenet_core_plain(mel, w1, g1, b1, w2, act_name)
    _dtype_code(mel)
    _check_shapes(mel, w1, g1, b1, w2)
    mel, w1, g1, b1, w2 = (t.contiguous() for t in (mel, w1, g1, b1, w2))
    check_cuda_args("fused_prenet_core", (torch.float32, torch.bfloat16),
                    mel=mel, w1=w1, g1=g1, b1=b1, w2=w2)
    if needs_grad:
        return _PrenetCore.apply(mel, w1, g1, b1, w2, act_name)
    return _launch_forward(mel, *_kernel_params(mel.dtype, w1, g1, b1, w2),
                           act_name)
