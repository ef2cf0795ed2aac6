"""Counter-based dropout masks shared by the kernels and their plain versions.

The JAX package's kernels draw dropout bits in interpret mode from a
murmur-style integer mixer over the element index
(``speechain_tpu/ops/pallas_attention.py::_dropout_mask``, :194-217):

    x    = lin * 2654435761 + seed          (uint32, wrapping)
    x   ^= x >> 16;  x *= 0x7FEB352D
    x   ^= x >> 15;  x *= 0x846CA68B
    bits = x ^ (x >> 16)
    keep = bits >= uint32(rate * 2^32),  scale 1 / (1 - rate)

The port draws every dropout mask this way: the CUDA kernels with the same
mixer as a device function (``csrc/common.cuh::dropout_bits``) and the plain
versions with :func:`dropout_bits` below, so a kernel and its plain version
keep the same elements, bit for bit, and both match the JAX kernels in
interpret mode. torch has no uint32 arithmetic, so the plain version works
in int64 and reduces modulo 2^32 after every step.

Streams: attention uses ``seed + b * H + h`` and element ``q * Tk + k``;
the FFN uses ``seed + row_block`` and element ``local_row * C + col`` with
blocks of :func:`pick_rows` rows. Dropout outside the kernels (residual and
positional-encoding dropout) uses one stream per call over the tensor
flattened to (rows, last dim).

Seeds are int32 values drawn from the training step's ``torch.Generator``
(:func:`draw_seed`, inside :func:`step_rng`), so a step is reproducible
from its generator on any device.
"""

from __future__ import annotations

import contextlib
from typing import Iterator, List, Optional

import torch

M32 = 0xFFFFFFFF
BLOCK_ROWS = 256            # speechain_tpu/ops/pallas_ffn.py:34


def pick_rows(N: int) -> int:
    """Rows per FFN dropout stream: a copy of
    ``speechain_tpu/ops/pallas_ffn.py::_pick_rows`` (:52-56)."""
    r = BLOCK_ROWS
    while r > 8 and N % r:
        r //= 2
    return r if N % r == 0 else N


def _mul32(x: torch.Tensor, c: int) -> torch.Tensor:
    """(x * c) mod 2^32 for int64 x in [0, 2^32) without int64 overflow."""
    lo = (x & 0xFFFF) * c
    hi = ((x >> 16) * c) & 0xFFFF
    return (lo + (hi << 16)) & M32


def dropout_bits(lin: torch.Tensor, seed) -> torch.Tensor:
    """The mixer's uint32 bits (as int64) for element indices ``lin`` and
    an int32 ``seed``, a Python int or an int64 tensor of per-element
    seeds (taken modulo 2^32). A Python int stays a scalar operand: no
    host-to-device copy."""
    x = (_mul32(lin.to(torch.int64) & M32, 2654435761) + (seed & M32)) & M32
    x = x ^ (x >> 16)
    x = _mul32(x, 0x7FEB352D)
    x = x ^ (x >> 15)
    x = _mul32(x, 0x846CA68B)
    return x ^ (x >> 16)


def threshold(rate: float) -> int:
    """uint32 keep threshold, as ``jnp.uint32(int(rate * 2**32))``."""
    return int(rate * float(2 ** 32))


def keep_scale(rate: float) -> float:
    return 1.0 / (1.0 - rate)


def kernel_args(rate: float, seed: int):
    """A dropout site's arguments for the CUDA kernels: (on, seed mod
    2^32, threshold, scale)."""
    if rate <= 0.0:
        return [0, 0, 0, 0.0]
    return [1, seed & M32, threshold(rate), keep_scale(rate)]


def mask_from_bits(bits: torch.Tensor, rate: float) -> torch.Tensor:
    """float32 keep-mask times 1 / (1 - rate)."""
    return (bits >= threshold(rate)).to(torch.float32) * keep_scale(rate)


def rows_mask(R: int, C: int, rate: float, seed,
              device=None) -> torch.Tensor:
    """(R, C) mask of one stream, element ``r * C + c``."""
    lin = torch.arange(R * C, device=device, dtype=torch.int64).reshape(R, C)
    return mask_from_bits(dropout_bits(lin, seed), rate)


def ffn_mask(N: int, C: int, rate: float, seed: int,
             device=None) -> torch.Tensor:
    """(N, C) mask of the FFN kernels: stream ``seed + row // R`` and
    element ``(row % R) * C + col`` with R = :func:`pick_rows` (N)."""
    R = pick_rows(N)
    rows = torch.arange(N, device=device, dtype=torch.int64)[:, None]
    cols = torch.arange(C, device=device, dtype=torch.int64)[None, :]
    lin = (rows % R) * C + cols
    return mask_from_bits(dropout_bits(lin, seed + rows // R), rate)


def attention_mask(B: int, H: int, Tq: int, Tk: int, rate: float, seed: int,
                   device=None) -> torch.Tensor:
    """(B, H, Tq, Tk) mask of the attention kernels: stream
    ``seed + b * H + h``, element ``q * Tk + k``."""
    bh = torch.arange(B * H, device=device,
                      dtype=torch.int64).reshape(B, H, 1, 1)
    lin = torch.arange(Tq * Tk, device=device,
                       dtype=torch.int64).reshape(1, 1, Tq, Tk)
    return mask_from_bits(dropout_bits(lin, seed + bh), rate)


# ----------------------------------------------------------- step generator

_GENERATORS: List[torch.Generator] = []


@contextlib.contextmanager
def step_rng(generator: torch.Generator) -> Iterator[None]:
    """Draw every random number of a training forward inside the block
    (dropout seeds, SpecAugment) from ``generator``."""
    _GENERATORS.append(generator)
    try:
        yield
    finally:
        _GENERATORS.pop()


def step_generator() -> torch.Generator:
    """The innermost :func:`step_rng` generator."""
    if not _GENERATORS:
        raise RuntimeError("randomness in training needs a generator: run "
                           "the forward inside step_rng(generator)")
    return _GENERATORS[-1]


def draw_seed() -> int:
    """One int32 seed from the :func:`step_rng` generator (a host draw
    when the generator is on the CPU: no device synchronisation)."""
    return int(torch.randint(-2 ** 31, 2 ** 31 - 1, (1,),
                             generator=step_generator()))


def dropout(x: torch.Tensor, rate: float, training: bool,
            seed: Optional[int] = None) -> torch.Tensor:
    """Dropout with one mixer stream over x flattened to (rows, last dim)
    (the port's ``FlatDropout``); identity in evaluation or at rate 0."""
    if not training or rate <= 0.0:
        return x
    if seed is None:
        seed = draw_seed()
    C = x.shape[-1]
    R = x.numel() // C
    mask = rows_mask(R, C, rate, seed, device=x.device).reshape(x.shape)
    return (x.float() * mask).to(x.dtype)
