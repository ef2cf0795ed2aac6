"""Dense (linear) layer and 1-D convolution in a compute dtype.

The JAX package keeps float32 parameters and casts them to the module's
``dtype`` at each use (flax ``nn.Dense(dtype=...)``). For serving, the port
stores each parameter in the dtype it is used in, so loading a float32
checkpoint rounds it once, exactly as the per-use cast does, and the cast
is a no-op on every call. For training the network's parameters are
float32 master weights (``ARASRConfig.param_dtype``), and the cast at use
rounds them to the compute dtype as flax does; gradients reach the master
weights in float32. Weights are in PyTorch layout (out, in), and (out,
in / groups, K) for :class:`Conv1d`, flax ``nn.Conv`` with XLA's padding.
"""

from __future__ import annotations

from typing import Optional

import torch
import torch.nn.functional as F
from torch import nn


class Dense(nn.Module):
    def __init__(self, in_features: int, out_features: int, bias: bool = True,
                 dtype: torch.dtype = torch.float32,
                 bias_dtype: Optional[torch.dtype] = None):
        super().__init__()
        self.weight = nn.Parameter(torch.zeros(out_features, in_features,
                                               dtype=dtype))
        self.bias = (nn.Parameter(torch.zeros(out_features,
                                              dtype=bias_dtype or dtype))
                     if bias else None)
        self.dtype = dtype

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        w, b = self.weight, self.bias
        if w.dtype != self.dtype:             # float32 master weights
            w = w.to(self.dtype)
        if b is not None and b.dtype != self.dtype:
            b = b.to(self.dtype)
        return F.linear(x.to(self.dtype), w, b)


def same_padding(T: int, kernel_size: int, stride: int = 1,
                 dilation: int = 1):
    """(low, high) padding of XLA's ``'SAME'`` for a length-T axis:
    ceil(T / stride) outputs, the extra pad on the high side."""
    out = -(-T // stride)
    total = max((out - 1) * stride + dilation * (kernel_size - 1) + 1 - T, 0)
    return total // 2, total - total // 2


class Conv1d(nn.Module):
    """flax ``nn.Conv`` over one axis in a compute dtype (weights and bias
    cast at use, as :class:`Dense`): weight in PyTorch layout (out,
    in / groups, K), ``padding`` an explicit (low, high) pair or
    ``"SAME"``. :meth:`forward` takes flax's channels-last (B, T, C);
    ``channels_last=False`` takes PyTorch's (B, C, T), for callers that
    keep that layout between convolutions."""

    def __init__(self, in_channels: int, out_channels: int,
                 kernel_size: int, stride: int = 1, dilation: int = 1,
                 padding="SAME", bias: bool = True, groups: int = 1,
                 dtype: torch.dtype = torch.float32):
        super().__init__()
        self.weight = nn.Parameter(torch.zeros(
            out_channels, in_channels // groups, kernel_size, dtype=dtype))
        self.bias = (nn.Parameter(torch.zeros(out_channels, dtype=dtype))
                     if bias else None)
        self.kernel_size, self.stride = kernel_size, stride
        self.dilation, self.groups = dilation, groups
        self.padding = padding
        self.dtype = dtype

    def forward(self, x: torch.Tensor,
                channels_last: bool = True) -> torch.Tensor:
        w, b = self.weight, self.bias
        if w.dtype != self.dtype:             # float32 master weights
            w = w.to(self.dtype)
        if b is not None and b.dtype != self.dtype:
            b = b.to(self.dtype)
        x = x.to(self.dtype)
        if channels_last:
            x = x.transpose(1, 2)
        lo, hi = (same_padding(x.shape[-1], self.kernel_size, self.stride,
                               self.dilation) if self.padding == "SAME"
                  else self.padding)
        if lo != hi:
            x = F.pad(x, (lo, hi))
            lo = 0
        y = F.conv1d(x, w, b, self.stride, lo, self.dilation, self.groups)
        return y.transpose(1, 2) if channels_last else y
