"""Position-wise feed-forward layer (counterpart of
``speechain_tpu/nn/feed_forward.py``), 'linear' type, evaluation path.

``act(x W1^T + b1) W2^T + b2`` with the optional residual epilogue
``residual + res_scale * ffn(x)``, both through the fused kernel wrapper
(``ops/cuda_ffn.py``): the CUDA kernel for a tensor on the card, its plain
version on the CPU. Parameters follow the TPU kernel: weights in the
compute dtype, biases in float32. The 'conv' type is not on the serving
path of conformer-small and is not ported yet.
"""

from __future__ import annotations

from typing import Any, Dict, Optional

import torch
from torch import nn

from speechain_tpu_torch.nn.dense import Dense
from speechain_tpu_torch.ops.cuda_ffn import (ACTIVATIONS, cuda_ffn,
                                              get_activation)

__all__ = ["ACTIVATIONS", "get_activation", "PositionwiseFeedForward"]


class PositionwiseFeedForward(nn.Module):
    def __init__(self, d_model: int, fdfwd_dim: int,
                 fdfwd_type: str = "linear", fdfwd_activation: str = "ReLU",
                 fdfwd_args: Optional[Dict[str, Any]] = None,
                 dropout: float = 0.1, dtype: torch.dtype = torch.float32):
        super().__init__()
        if fdfwd_type != "linear":
            raise NotImplementedError(
                f"fdfwd_type {fdfwd_type!r} is not ported yet")
        get_activation(fdfwd_activation)           # validate the name
        self.activation = fdfwd_activation
        self.dtype = dtype
        self.in_layer = Dense(d_model, fdfwd_dim, dtype=dtype,
                              bias_dtype=torch.float32)
        self.out_layer = Dense(fdfwd_dim, d_model, dtype=dtype,
                               bias_dtype=torch.float32)

    def forward(self, x: torch.Tensor,
                residual: Optional[torch.Tensor] = None,
                res_scale: float = 1.0) -> torch.Tensor:
        """``[residual + res_scale *] ffn(x)`` in the compute dtype."""
        cd = self.dtype
        return cuda_ffn(x.to(cd), self.in_layer.weight, self.in_layer.bias,
                        self.out_layer.weight, self.out_layer.bias,
                        self.activation,
                        None if residual is None else residual.to(cd),
                        res_scale)
