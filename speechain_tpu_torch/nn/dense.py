"""Dense (linear) layer in a compute dtype.

The JAX package keeps float32 parameters and casts them to the module's
``dtype`` at each use (flax ``nn.Dense(dtype=...)``). For serving, the port
stores each parameter in the dtype it is used in, so loading a float32
checkpoint rounds it once, exactly as the per-use cast does, and the cast
is a no-op on every call. For training the network's parameters are
float32 master weights (``ARASRConfig.param_dtype``), and the cast at use
rounds them to the compute dtype as flax does; gradients reach the master
weights in float32. Weights are in PyTorch layout (out, in).
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
