"""Normalization modules, evaluation path (counterpart of
``speechain_tpu/nn/norms.py``).

- :class:`LayerNorm`: float32 statistics with the fast variance
  E[x^2] - E[x]^2, as the reference's XLA formula; output in x's dtype.
- :func:`bn_norm` / :class:`BatchNorm`: BatchNorm from running statistics,
  ``(u - mean) * rsqrt(var + eps) * scale + bias`` in float32. Updating the
  statistics is training work and comes with the training slice.
"""

from __future__ import annotations

import torch
from torch import nn


class LayerNorm(nn.Module):
    def __init__(self, dim: int, epsilon: float = 1e-6):
        super().__init__()
        self.weight = nn.Parameter(torch.ones(dim))
        self.bias = nn.Parameter(torch.zeros(dim))
        self.epsilon = epsilon

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        xf = x.float()
        mu = xf.mean(-1, keepdim=True)
        var = (xf * xf).mean(-1, keepdim=True) - mu * mu
        y = (xf - mu) * torch.rsqrt(var + self.epsilon)
        return (y * self.weight + self.bias).to(x.dtype)


def bn_norm(u, mean, var, scale, bias, eps: float) -> torch.Tensor:
    """y = (u - mean) * rsqrt(var + eps) * scale + bias in float32; the
    statistics broadcast against u's channel axis."""
    r = torch.rsqrt(var + eps)
    return (u.float() - mean) * r * scale + bias


class BatchNorm(nn.Module):
    """BatchNorm over the last axis from running statistics (flax
    ``BatchNorm(use_running_average=True)`` / ``FastBatchNorm`` eval);
    ``dtype`` is the output dtype."""

    def __init__(self, channels: int, epsilon: float = 1e-5,
                 dtype: torch.dtype = torch.float32):
        super().__init__()
        self.weight = nn.Parameter(torch.ones(channels))
        self.bias = nn.Parameter(torch.zeros(channels))
        self.register_buffer("running_mean", torch.zeros(channels))
        self.register_buffer("running_var", torch.ones(channels))
        self.epsilon = epsilon
        self.dtype = dtype

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return bn_norm(x, self.running_mean, self.running_var, self.weight,
                       self.bias, self.epsilon).to(self.dtype)
