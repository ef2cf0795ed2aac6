"""Fused feed-forward CUDA kernels with residual epilogue and dropout
(``csrc/ffn.cu``), forward and backward.

Forward: replaces ``speechain_tpu/ops/pallas_ffn.py::fused_ffn`` (forward
``pl.pallas_call`` at :180) and ``::fused_ffn_residual`` (:264), which
share the body ``_fwd_kernel`` (:59):

    out = [res + alpha * resdrop](drop(act(x W1^T + b1)) W2^T + b2)

Backward: replaces the backward ``pl.pallas_call`` at :207 and :293 (body
``_bwd_kernel`` :93): dx in the compute dtype and float32 dW1, db1, dW2,
db2, with the intermediate recomputed from x and both dropout masks
regenerated; ``dres`` is the output cotangent itself.

What bounds them on the H100: the operations. At transformer-wide
training (N = 16 x 199 rows, D = 512, F = 2048) the forward is 13.4 GFLOP
and the backward 33 GFLOP against ~10 MB and ~22 MB of traffic. In bf16
every product runs on the tensor cores (``mma.sync``, float32 sums): the
forward keeps the (rows, F) intermediate on chip, 64 rows a block, and
splits the output columns over blocks where the rows alone do not fill the
card (:func:`tc_geometry`); the backward's row pass writes dx and the (N,
F) dz and dropped activation, and one launch of 64 x 64 output tiles forms
dW1 and dW2, summing rows in a fixed order (deterministic). float32 keeps
the FMA-unit kernels (TF32 would break the 1e-4 contracts). The design is
in ``csrc/ffn.cu``'s header.

Rounding follows the TPU kernel: z rounded to the compute dtype before the
exact-erf GELU, the activation and the dropped activation rounded to the
compute dtype, the residual add in float32; in the backward g_c and dz in
the compute dtype. Dropout masks are ``ops/dropout.py::ffn_mask``'s, bit for
bit, in the kernels and the plain version alike.
"""

from __future__ import annotations

import functools
from typing import Dict, Optional, Tuple

import torch
import torch.nn.functional as F

from speechain_tpu_torch.ops import dropout as drop
from speechain_tpu_torch.ops.cuda_build import (SMEM_LIMIT, CudaKernel,
                                                I, P, U,
                                                check_cuda_args, stream_ptr)
from speechain_tpu_torch.ops.cuda_build import F as CF

_DROP = [I, U, U, CF, I, U, U, CF]       # inner and residual dropout sites
KERNEL = CudaKernel(
    name="ffn", source="ffn.cu",
    symbols={
        "ffn_forward": [P, P, P, P, P, P, P, I, I, I, I, I, I, CF, I, I,
                        *_DROP, P],
        "ffn_backward": [P, P, P, P, P, P, P, P, P, P, P, P, P, P, I, I, I,
                         I, I, I, CF, I, I, *_DROP, P]},
    replaces={"ffn_forward": "speechain_tpu/ops/pallas_ffn.py:264",
              "ffn_backward": "speechain_tpu/ops/pallas_ffn.py:293"})

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

# the bf16 tensor-core kernels' geometry (csrc/ffn.cu): 64-row tiles, 64-wide
# F chunks, K slices and output tiles, staged with rows padded by 8 values;
# 8 warps a row kernel, 4 for the weight gradients' 4-slot ring
TC_ROWS, TC_WIDTH, TC_THREADS, TC_WG_THREADS, TC_WG_SLOTS = 64, 64, 256, 128, 4
TC_TILES = (1, 2, 4)             # output tiles a block owns: the instances
TC_TILE_BYTES = TC_ROWS * (TC_WIDTH + 8) * 2
SM_REGISTERS = 65536
SM_SMEM = 228 * 1024             # an SM's shared memory, 1 KB per block


def get_activation(name: str):
    if name not in ACTIVATIONS:
        raise KeyError(f"unknown activation {name!r}; known: "
                       f"{sorted(ACTIVATIONS)}")
    return ACTIVATIONS[name][0]


def round_to(x: torch.Tensor, dtype: torch.dtype) -> torch.Tensor:
    """float32 ``x`` rounded to ``dtype`` and widened back; the gradient
    passes through unrounded, as the kernels keep their gradients float32
    between rounding points."""
    if dtype == torch.float32:
        return x
    return x + (x.to(dtype).float() - x).detach()


def ffn_plain(x: torch.Tensor, w1: torch.Tensor, b1: torch.Tensor,
              w2: torch.Tensor, b2: torch.Tensor, act: str = "GELU",
              residual: Optional[torch.Tensor] = None, alpha: float = 1.0,
              rate: float = 0.0, res_rate: float = 0.0, seed: int = 0,
              res_seed: int = 0) -> torch.Tensor:
    """The kernels' function in plain PyTorch, same rounding points and
    dropout masks; its autograd is the backward kernel's reference."""
    cd = x.dtype
    D = x.shape[-1]
    x2 = x.reshape(-1, D).float()
    N = x2.shape[0]
    z = x2 @ round_to(w1.float(), cd).t() + b1.float()
    h = round_to(get_activation(act)(round_to(z, cd)), cd)
    if rate > 0.0:
        h = round_to(h * drop.ffn_mask(N, h.shape[1], rate, seed, x.device),
                     cd)
    y = h @ round_to(w2.float(), cd).t() + b2.float()
    if residual is not None:
        if res_rate > 0.0:
            y = y * drop.ffn_mask(N, y.shape[1], res_rate, res_seed,
                                  x.device)
        y = residual.reshape(N, -1).float() + alpha * y
    return y.to(cd).reshape(*x.shape[:-1], -1)


def _rows_per_block(N: int, width: int, Fd: int, device) -> int:
    """float32 rows per block: the most of 16, 8, 4, 2 that still gives one
    block per SM and fits the shared memory, else 1."""
    sms = _sm_count(device)
    for r in (16, 8, 4, 2):
        smem = 4 * (r * (width + Fd) + _THREADS * (_BK + 1))
        if -(-N // r) >= sms and smem <= SMEM_LIMIT:
            return r
    return 1


def _smem_check(name: str, rows: int, width: int, Fd: int) -> None:
    smem = 4 * (rows * (width + Fd) + _THREADS * (_BK + 1))
    if smem > SMEM_LIMIT:
        raise ValueError(f"{name}: width {width}, F={Fd} need {smem} B of "
                         "shared memory")


@functools.lru_cache(maxsize=None)
def _sm_count(device) -> int:
    return torch.cuda.get_device_properties(device).multi_processor_count


def _tiles(n: int) -> int:
    return -(-n // TC_WIDTH)


def _staged_row_bytes(width: int) -> int:
    """A 64-row tile of ``width`` bf16 columns as staged: padded to a
    multiple of 64 plus 8 values a row."""
    return TC_ROWS * (_tiles(width) * TC_WIDTH + 8) * 2


def tc_smem_bytes(kind: str, D: int = 0, Do: int = 0) -> Tuple[int, int]:
    """(dynamic shared memory, ring slots) of the bf16 kernel ``kind``
    ("forward": ffn_fwd_tc at width D; "backward": ffn_bwd_rows_tc at
    widths D, Do; "wgrad": ffn_wgrad_tc), as ``csrc/ffn.cu`` reckons them:
    the staged row tiles, one 64 x 64 tile and a ring of 3 such tiles, 2
    where 3 do not fit. The smoke run holds this equal to the built
    kernels' own (``ffn_tc_attrs``)."""
    if kind == "wgrad":
        return TC_WG_SLOTS * 2 * TC_TILE_BYTES, TC_WG_SLOTS
    fixed = _staged_row_bytes(D) + TC_TILE_BYTES
    if kind == "backward":
        fixed += _staged_row_bytes(Do)
    elif kind != "forward":
        raise KeyError(kind)
    slots = 3 if fixed + 3 * TC_TILE_BYTES <= SMEM_LIMIT else 2
    return fixed + slots * TC_TILE_BYTES, slots


def tc_blocks_per_sm(kind: str, nt: int = 1) -> int:
    """Blocks an SM that an instance's launch bounds ask for
    (``csrc/ffn.cu`` fwd_blocks, bwd_blocks, WG_BLOCKS)."""
    if kind == "wgrad":
        return 3
    if kind == "forward":
        return 3 if nt <= 1 else 2
    return 2 if nt <= 2 else 1


def tc_register_budget(kind: str, nt: int = 1) -> int:
    """Registers a thread may hold under an instance's launch bounds: the
    SM's 65,536 over the threads of the blocks they ask for, in steps of
    8, at most 255."""
    threads = TC_WG_THREADS if kind == "wgrad" else TC_THREADS
    per = SM_REGISTERS // (threads * tc_blocks_per_sm(kind, nt))
    return min(255, per // 8 * 8)


# work an SM gets done with 1, 2 or 3 blocks resident, relative to one
# block alone (a lone block of the row kernels waits on its barriers,
# copies and epilogues): fitted so that tc_geometry picks the fastest
# instance of chip_smoke.py phase 2b's tile sweep at every path shape
# on the H100 (the sweep fails where it does not)
CO_RESIDENT_GAIN = {1: 1.0, 2: 1.6, 3: 1.9}


@functools.lru_cache(maxsize=None)
def tc_geometry(kind: str, N: int, D: int, Do: int, sms: int = 132
                ) -> Tuple[int, int]:
    """(NT, column groups) of a bf16 row kernel: a block owns NT 64-wide
    output tiles (of Do in the forward, of D in the backward's dx) and
    recomputes its rows' products with W1 (and W2) for them. Picks the NT
    under which the busiest SM finishes first: the blocks it must run
    times a block's products (K = D, plus Do in the backward, plus its own
    output columns), over the gain of the blocks that share it at once
    (as many as the launch bounds ask for and the shared memory holds);
    ties go to the smaller NT."""
    out = Do if kind == "forward" else D
    k_in = D if kind == "forward" else D + Do
    rows, need = -(-N // TC_ROWS), _tiles(out)
    best = None
    for nt in TC_TILES:
        if nt > 1 and nt // 2 >= need:      # a block would own empty tiles
            break
        groups = -(-need // nt)
        per_sm = -(-rows * groups // sms)
        resident = min(per_sm, tc_blocks_per_sm(kind, nt), SM_SMEM // (
            tc_smem_bytes(kind, D, Do)[0] + 1024))
        cost = (per_sm * (k_in + TC_WIDTH * min(nt, need))
                / CO_RESIDENT_GAIN[resident])
        if best is None or cost < best[0]:
            best = (cost, nt, groups)
    return best[1], best[2]


def check_tc_widths(name: str, D: int, Fd: int, Do: int,
                    backward: bool) -> None:
    """Raise, naming the width, unless the bf16 kernels take D, F and Do:
    multiples of 8 whose staged row tiles fit the shared memory with a ring
    of 2 tiles: D up to 1,536 in the forward, and in the backward D and Do,
    each rounded up to a multiple of 64, up to 1,536 together (every
    recipe's widths, 256 to 768, fit)."""
    for label, n in (("D", D), ("F", Fd), ("Do", Do)):
        if n <= 0 or n % 8:
            raise ValueError(f"{name}: width {label}={n} is not a positive "
                             "multiple of 8")
    kind = "backward" if backward else "forward"
    smem, _ = tc_smem_bytes(kind, D, Do)
    if smem > SMEM_LIMIT:
        raise ValueError(f"{name}: widths D={D}, Do={Do} need {smem} B of "
                         f"shared memory ({kind}), more than {SMEM_LIMIT}")


def check_aligned(name: str, **tensors) -> None:
    """Raise, naming the pointer, unless every tensor's data lies at a
    16-byte aligned address (the bf16 kernels copy 16 bytes at a time)."""
    for arg, t in tensors.items():
        if t is not None and t.data_ptr() % 16:
            raise ValueError(f"{name}: pointer {arg} is not 16-byte aligned")


def built_tc_attrs(kind: str, nt: int = 1, D: int = 0, Do: int = 0
                   ) -> Dict[str, int]:
    """The built bf16 kernel's shared memory (static plus dynamic),
    registers and spill bytes a thread, and ring slots, from the library
    (``ffn_tc_attrs``). Builds the kernels; needs a card."""
    import ctypes
    fn = KERNEL.lib.ffn_tc_attrs
    fn.argtypes = [I, I, I, I, P]
    out = (ctypes.c_longlong * 4)()
    err = fn(("forward", "backward", "wgrad").index(kind), nt, D, Do, out)
    if err != 0:
        raise RuntimeError(f"ffn_tc_attrs failed with cudaError {err}")
    return dict(zip(("smem", "registers", "spill_bytes", "slots"), out))


def _as(t: torch.Tensor, dtype: torch.dtype) -> torch.Tensor:
    """``t`` in ``dtype``, contiguous (a cast only where one is needed)."""
    if t.dtype != dtype:
        t = t.to(dtype)
    return t if t.is_contiguous() else t.contiguous()


def _launch_forward(x2, r2, w1, b1, w2, b2, act, alpha, rate, res_rate,
                    seed, res_seed):
    """The forward kernel; returns (out, (weights and biases as used))."""
    cd = x2.dtype
    N, D = x2.shape
    Fd, Do = w1.shape[0], w2.shape[0]
    w1c, w2c = _as(w1, cd), _as(w2, cd)
    b1f, b2f = _as(b1, torch.float32), _as(b2, torch.float32)
    check_cuda_args("cuda_ffn", {"b1": (torch.float32,),
                                 "b2": (torch.float32,), "*": (cd,)},
                    x=x2, w1=w1c, b1=b1f, w2=w2c, b2=b2f, residual=r2)
    if cd == torch.float32:
        rows = _rows_per_block(N, D, Fd, x2.device)
        _smem_check("cuda_ffn", rows, D, Fd)
    else:
        check_tc_widths("cuda_ffn", D, Fd, Do, backward=False)
        check_aligned("cuda_ffn", x=x2, w1=w1c, w2=w2c, residual=r2)
        rows = tc_geometry("forward", N, D, Do, _sm_count(x2.device))[0]
    out = torch.empty(N, Do, device=x2.device, dtype=cd)
    KERNEL.launch(
        "ffn_forward", x2.data_ptr(), w1c.data_ptr(), b1f.data_ptr(),
        w2c.data_ptr(), b2f.data_ptr(),
        None if r2 is None else r2.data_ptr(), out.data_ptr(), N, D, Fd,
        Do, rows, ACTIVATIONS[act][1], float(alpha),
        0 if cd == torch.float32 else 1, drop.pick_rows(N),
        *drop.kernel_args(rate, seed),
        *drop.kernel_args(res_rate if r2 is not None else 0.0, res_seed),
        stream_ptr(x2))
    return out, (w1c, b1f, w2c)


class _FFN(torch.autograd.Function):
    """The forward kernel, with the backward kernel as its gradient."""

    @staticmethod
    def forward(ctx, x2, r2, w1, b1, w2, b2, act, alpha, rate, res_rate,
                seed, res_seed):
        out, (w1c, b1f, w2c) = _launch_forward(
            x2, r2, w1, b1, w2, b2, act, alpha, rate, res_rate, seed,
            res_seed)
        ctx.save_for_backward(x2, w1c, b1f, w2c)
        ctx.cfg = (act, alpha, rate, res_rate, seed, res_seed,
                   r2 is not None, w1.dtype, b1.dtype, w2.dtype, b2.dtype)
        return out

    @staticmethod
    def backward(ctx, g):
        x2, w1c, b1f, w2c = ctx.saved_tensors
        (act, alpha, rate, res_rate, seed, res_seed, has_res, w1t, b1t, w2t,
         b2t) = ctx.cfg
        dx, dw1, db1, dw2, db2 = ffn_backward(
            x2, w1c, b1f, w2c, g.contiguous(), act,
            alpha if has_res else 1.0, rate,
            res_rate if has_res else 0.0, seed, res_seed)
        return (dx, g if has_res else None, dw1.to(w1t), db1.to(b1t),
                dw2.to(w2t), db2.to(b2t), None, None, None, None, None, None)


def ffn_backward(x2, w1c, b1f, w2c, g, act: str, alpha: float, rate: float,
                 res_rate: float, seed: int, res_seed: int):
    """The backward kernel: (dx, dW1, db1, dW2, db2) for x2 (N, D), weights
    in x2's dtype, b1 float32 and the output cotangent g (N, Do)."""
    cd = x2.dtype
    N, D = x2.shape
    Fd, Do = w1c.shape[0], w2c.shape[0]
    check_cuda_args("ffn_backward", {"b1": (torch.float32,), "*": (cd,)},
                    x=x2, w1=w1c, b1=b1f, w2=w2c, g=g)
    if cd == torch.float32:
        width = max(D, Do)
        rows = _rows_per_block(N, width, Fd, x2.device)
        _smem_check("ffn_backward", rows, width, Fd)
    else:
        check_tc_widths("ffn_backward", D, Fd, Do, backward=True)
        check_aligned("ffn_backward", x=x2, w1=w1c, w2=w2c, g=g)
        rows = tc_geometry("backward", N, D, Do, _sm_count(x2.device))[0]
    dev = x2.device
    dx = torch.empty(N, D, device=dev, dtype=cd)
    ht = torch.empty(N, Fd, device=dev, dtype=cd)
    dz = torch.empty(N, Fd, device=dev, dtype=cd)
    gc = torch.empty(N, Do, device=dev, dtype=cd)
    gs = torch.empty(N, Do, device=dev, dtype=torch.float32)
    dw1 = torch.empty(Fd, D, device=dev, dtype=torch.float32)
    db1 = torch.empty(Fd, device=dev, dtype=torch.float32)
    dw2 = torch.empty(Do, Fd, device=dev, dtype=torch.float32)
    db2 = torch.empty(Do, device=dev, dtype=torch.float32)
    KERNEL.launch(
        "ffn_backward", x2.data_ptr(), w1c.data_ptr(), b1f.data_ptr(),
        w2c.data_ptr(), g.data_ptr(), dx.data_ptr(), ht.data_ptr(),
        dz.data_ptr(), gc.data_ptr(), gs.data_ptr(), dw1.data_ptr(),
        db1.data_ptr(), dw2.data_ptr(), db2.data_ptr(), N, D, Fd, Do, rows,
        ACTIVATIONS[act][1], float(alpha), 0 if cd == torch.float32 else 1,
        drop.pick_rows(N), *drop.kernel_args(rate, seed),
        *drop.kernel_args(res_rate, res_seed), stream_ptr(x2))
    return dx, dw1, db1, dw2, db2


def cuda_ffn(x: torch.Tensor, w1: torch.Tensor, b1: torch.Tensor,
             w2: torch.Tensor, b2: torch.Tensor, act: str = "GELU",
             residual: Optional[torch.Tensor] = None, alpha: float = 1.0,
             rate: float = 0.0, res_rate: float = 0.0, seed: int = 0,
             res_seed: int = 0) -> torch.Tensor:
    """x (..., D) in float32 or bfloat16; w1 (F, D) and w2 (Do, F) in any
    float dtype (cast to x's dtype at use, gradients returned in theirs);
    b1 (F,), b2 (Do,); residual (..., Do) in x's dtype or None. ``rate``
    drops the activation, ``res_rate`` the FFN output before the residual
    add (residual form only); seeds are int32. Returns (..., Do) in x's
    dtype, differentiable in x, residual, weights and biases.

    A CPU tensor takes :func:`ffn_plain`; a CUDA tensor takes the kernels.
    """
    if act not in ACTIVATIONS:
        raise KeyError(f"unknown activation {act!r}")
    if not x.is_cuda:
        return ffn_plain(x, w1, b1, w2, b2, act, residual, alpha, rate,
                         res_rate, seed, res_seed)
    lead = x.shape[:-1]
    D = x.shape[-1]
    Fd, Do = w1.shape[0], w2.shape[0]
    if w1.shape != (Fd, D) or w2.shape != (Do, Fd):
        raise ValueError(f"cuda_ffn: weights {tuple(w1.shape)}, "
                         f"{tuple(w2.shape)} do not fit x (..., {D})")
    if b1.shape != (Fd,) or b2.shape != (Do,):
        raise ValueError("cuda_ffn: bias shapes do not fit the weights")
    if x.dtype not in (torch.float32, torch.bfloat16):
        raise ValueError(f"cuda_ffn: unsupported dtype {x.dtype}")
    x2 = x.reshape(-1, D).contiguous()
    r2 = None
    if residual is not None:
        if residual.shape != (*lead, Do):
            raise ValueError("cuda_ffn: residual shape does not fit")
        r2 = residual.reshape(-1, Do).contiguous()
    args = (x2, r2, w1, b1, w2, b2, act, float(alpha), float(rate),
            float(res_rate), int(seed), int(res_seed))
    if torch.is_grad_enabled() and any(
            t is not None and t.requires_grad for t in args[:6]):
        out = _FFN.apply(*args)
    else:                                   # no graph to record
        out = _launch_forward(*args)[0]
    return out.reshape(*lead, Do)
