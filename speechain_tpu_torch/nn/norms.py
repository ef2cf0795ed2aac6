"""Normalization and flat dropout (counterpart of
``speechain_tpu/nn/norms.py``).

- :class:`LayerNorm`: float32 statistics with the fast variance
  E[x^2] - E[x]^2, as the reference's XLA formula; output in x's dtype.
  With ``fused`` (default: the reference's ``SPEECHAIN_FORCE_FUSED_LN``
  switch, ``ops/cuda_layernorm.py::fused_ln_enabled``) it goes through the
  LayerNorm kernels wherever the reference's gate (:159-163) sends a
  LayerNorm to its Pallas kernel: rows a multiple of 8, width a multiple
  of 128; elsewhere the same formula in plain PyTorch.
- :func:`bn_norm` / :class:`BatchNorm`: ``(u - mean) * rsqrt(var + eps) *
  scale + bias`` in float32, the reference's ``FastBatchNorm`` (:68-119).
  In evaluation the statistics are the running ones; in training they are
  the batch's, from one (sum, sum of squares) pass with the biased
  var = max(E[x^2] - mean^2, 0) over every position, padded frames
  included, as flax's; the running statistics then move as flax's do,
  ``0.9 * old + 0.1 * batch`` (flax's momentum keeps the OLD share, the
  opposite of ``torch.nn.BatchNorm``'s ``momentum``), with the same biased
  variance (``nn.BatchNorm2d`` would take the unbiased one). The
  reference's 2-reduction ``bn_norm`` VJP (:29-65) is an XLA memory
  optimization of the same gradient; plain autograd computes it here.
  :meth:`BatchNorm.from_moments` normalises with batch moments computed
  elsewhere (the conv-module kernel's per-channel sums), the counterpart
  of ``_BNApply`` (``speechain_tpu/nn/conformer.py:137-175``);
  :meth:`BatchNorm.affine` returns the normalisation as an affine (g, b)
  from such moments, the counterpart of ``_BNAffine``
  (``speechain_tpu/nn/prenets.py:217-256``), for the fused prenet core.
- :class:`FlatDropout` (:122-145): dropout with one mask stream over the
  tensor flattened to (rows, last dim), ``ops/dropout.py``.
"""

from __future__ import annotations

import math
from typing import Optional, Sequence

import torch
from torch import nn

from speechain_tpu_torch.ops.cuda_layernorm import (fused_layer_norm,
                                                     fused_ln_enabled,
                                                     layer_norm_plain)
from speechain_tpu_torch.ops.dropout import dropout


class LayerNorm(nn.Module):
    def __init__(self, dim: int, epsilon: float = 1e-6,
                 fused: Optional[bool] = None):
        super().__init__()
        self.weight = nn.Parameter(torch.ones(dim))
        self.bias = nn.Parameter(torch.zeros(dim))
        self.epsilon = epsilon
        self.fused = fused_ln_enabled() if fused is None else fused

    def takes_kernel(self, x: torch.Tensor) -> bool:
        """The reference's gate: the fused route, rows a multiple of 8 and
        a width that is a multiple of 128."""
        return (self.fused and math.prod(x.shape[:-1]) % 8 == 0
                and x.shape[-1] % 128 == 0)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        if self.takes_kernel(x):
            return fused_layer_norm(x, self.weight, self.bias, self.epsilon)
        return layer_norm_plain(x, self.weight, self.bias, self.epsilon)


def bn_norm(u, mean, var, scale, bias, eps: float) -> torch.Tensor:
    """y = (u - mean) * rsqrt(var + eps) * scale + bias in float32; the
    statistics broadcast against u's channel axis."""
    r = torch.rsqrt(var + eps)
    return (u.float() - mean) * r * scale + bias


class BatchNorm(nn.Module):
    """``FastBatchNorm`` over the last axis (see the module docstring);
    ``dtype`` is the output dtype."""

    def __init__(self, channels: int, epsilon: float = 1e-5,
                 dtype: torch.dtype = torch.float32, momentum: float = 0.9):
        super().__init__()
        self.weight = nn.Parameter(torch.ones(channels))
        self.bias = nn.Parameter(torch.zeros(channels))
        self.register_buffer("running_mean", torch.zeros(channels))
        self.register_buffer("running_var", torch.ones(channels))
        self.epsilon = epsilon
        self.momentum = momentum
        self.dtype = dtype

    def statistics(self, x: torch.Tensor, dims: Sequence[int]):
        """(mean, var) to normalize with, reduced over ``dims``: the running
        statistics in evaluation; in training the batch's (differentiable),
        after which the running statistics move towards them."""
        if not self.training:
            return self.running_mean, self.running_var
        n = 1
        for d in dims:
            n *= x.shape[d]
        xf = x.float()
        mean = xf.sum(dims) / n
        var = torch.clamp((xf * xf).sum(dims) / n - mean * mean, min=0.0)
        self._update_running(mean, var)
        return mean, var

    def _update_running(self, mean: torch.Tensor,
                        var: torch.Tensor) -> None:
        with torch.no_grad():
            m = self.momentum
            self.running_mean.copy_(m * self.running_mean
                                    + (1.0 - m) * mean)
            self.running_var.copy_(m * self.running_var + (1.0 - m) * var)

    def _normalize(self, x, mean, var) -> torch.Tensor:
        return bn_norm(x, mean, var, self.weight.float(), self.bias.float(),
                       self.epsilon).to(self.dtype)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        mean, var = self.statistics(x, tuple(range(x.ndim - 1)))
        return self._normalize(x, mean, var)

    def affine(self, mean: torch.Tensor, mean2: torch.Tensor):
        """The normalisation as an affine (g, b), g = scale * rsqrt(var +
        eps), b = bias - mean * g: in training from the batch moments mean
        and mean2 = E[x^2] (differentiable), var = max(mean2 - mean^2, 0),
        moving the running statistics as :meth:`statistics` does; in
        evaluation from the running statistics (mean, mean2 unused)."""
        if self.training:
            var = torch.clamp(mean2 - mean * mean, min=0.0)
            self._update_running(mean, var)
        else:
            mean, var = self.running_mean, self.running_var
        g = self.weight.float() * torch.rsqrt(var + self.epsilon)
        return g, self.bias.float() - mean * g

    def from_moments(self, x: torch.Tensor, s: torch.Tensor,
                     ss: torch.Tensor, n: int) -> torch.Tensor:
        """Normalise x over its last axis with the batch moments
        mean = s / n and mean2 = ss / n (per-channel sum and sum of
        squares of x over its n positions, differentiable) in training,
        var = max(mean2 - mean^2, 0), moving the running statistics as
        :meth:`statistics` does; the running statistics in evaluation."""
        if not self.training:
            return self._normalize(x, self.running_mean, self.running_var)
        mean, mean2 = s / n, ss / n
        var = torch.clamp(mean2 - mean * mean, min=0.0)
        self._update_running(mean, var)
        return self._normalize(x, mean, var)


class FlatDropout(nn.Module):
    def __init__(self, rate: float):
        super().__init__()
        self.rate = rate

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return dropout(x, self.rate, self.training)
