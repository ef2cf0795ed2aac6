"""Delta / delta-delta features.

Counterpart of ``speechain_tpu/ops/delta.py``: regression deltas over a
+/-N window (weights k / (2 sum(i^2))), concatenated onto the static
features, zero-padded at the edges. Each feature dimension is filtered on
its own: one depthwise ``F.conv1d`` over (B, D, T).
"""

from __future__ import annotations

import numpy as np
import torch
import torch.nn.functional as F


def delta_filter(delta_N: int = 2) -> np.ndarray:
    k = np.arange(-delta_N, delta_N + 1, dtype=np.float64)
    return (k / (2.0 * sum(i ** 2 for i in range(1, delta_N + 1)))
            ).astype(np.float32)


def add_delta_features(feat: torch.Tensor, feat_len: torch.Tensor, *,
                       delta_order: int = 2, delta_N: int = 2):
    """feat (B, T, D) -> (B, T, D * (1 + delta_order)); feat_len
    unchanged. ``delta_order`` 1 or 2 (the delta of the delta)."""
    if delta_order not in (1, 2):
        raise ValueError(f"delta_order must be 1 or 2, got {delta_order}")
    D = feat.shape[-1]
    w = torch.from_numpy(delta_filter(delta_N)).to(feat.device, feat.dtype)
    weight = w.expand(D, 1, 2 * delta_N + 1)

    def apply_once(x):
        return F.conv1d(x.transpose(1, 2), weight, padding=delta_N,
                        groups=D).transpose(1, 2)

    stack = [feat, apply_once(feat)]
    if delta_order == 2:
        stack.append(apply_once(stack[1]))
    return torch.cat(stack, dim=-1), feat_len
