"""Length/causal mask helpers (counterpart of ``speechain_tpu/utils/masks.py``).

Masks are boolean, True = valid / attendable.
"""

from __future__ import annotations

import torch


def make_mask_from_len(lengths: torch.Tensor, max_len: int) -> torch.Tensor:
    """(batch,) int lengths -> (batch, 1, max_len) bool mask, True = valid."""
    pos = torch.arange(max_len, device=lengths.device, dtype=torch.int32)
    return pos[None, None, :] < lengths.to(torch.int32)[:, None, None]


def subsequent_mask(size: int, device=None) -> torch.Tensor:
    """(1, size, size) lower-triangular causal mask, True = attendable."""
    return torch.ones(size, size, dtype=torch.bool,
                      device=device).tril()[None]


def combine_masks(*masks):
    """AND of broadcastable boolean masks, ignoring Nones."""
    out = None
    for m in masks:
        if m is None:
            continue
        out = m if out is None else (out & m)
    return out


def mask_to_bias(mask: torch.Tensor, dtype=torch.float32) -> torch.Tensor:
    """Boolean attention mask -> additive bias (0 where True, big-neg where
    False)."""
    big_neg = -1e9 if dtype == torch.float32 else -1e4
    zero = torch.zeros((), dtype=dtype, device=mask.device)
    return torch.where(mask, zero, torch.full((), big_neg, dtype=dtype,
                                              device=mask.device))
