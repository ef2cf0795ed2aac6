"""Position-wise feed-forward layer (counterpart of
``speechain_tpu/nn/feed_forward.py``), 'linear' and 'conv' types.

``drop(act(x W1^T + b1)) W2^T + b2`` with the optional residual epilogue
``residual + res_scale * resdrop(ffn(x))``, both through the fused kernel
wrapper (``ops/cuda_ffn.py``): the CUDA kernels (forward, and backward
through autograd) for a tensor on the card, the plain version on the CPU.
In training mode each dropout with a rate above 0 draws its int32 seed
from the step's generator, the inner one first (feed_forward.py:150-165);
the kernels draw the masks from it. Parameters follow the TPU kernel:
weights cast to the compute dtype at use, biases in float32.

The reference takes its Pallas kernel only when the rows are a multiple
of 8 and the widths of 128 (``_ffn_fused_ok``, feed_forward.py:91-99),
else XLA's unfused Dense layers with flax dropout; the port always takes
its kernel, whose arithmetic is the same and whose dropout realization is
the kernel's.

The 'conv' type (feed_forward.py:181-201, every FastSpeech2 recipe's) is
two 'SAME' convolutions over time of ``fdfwd_args["kernel_size"]`` (3 by
default) with the activation and dropout between them and the residual
epilogue after: plain ``F.conv1d`` in the compute dtype, as the reference
computes it outside any Pallas kernel; weights and biases cast to the
compute dtype at use (flax ``nn.Conv(dtype=...)``). The 'moe' type raises
here, as the reference's does (feed_forward.py:186): only the transformer
encoder layer builds it, as ``nn/moe.py::SwitchFFN``.
"""

from __future__ import annotations

from typing import Any, Dict, Optional

import torch
from torch import nn

from speechain_tpu_torch.nn.dense import Conv1d, Dense
from speechain_tpu_torch.ops.dropout import draw_seed, dropout
from speechain_tpu_torch.ops.cuda_ffn import (ACTIVATIONS, cuda_ffn,
                                              get_activation)

__all__ = ["ACTIVATIONS", "get_activation", "PositionwiseFeedForward"]


class PositionwiseFeedForward(nn.Module):
    def __init__(self, d_model: int, fdfwd_dim: int,
                 fdfwd_type: str = "linear", fdfwd_activation: str = "ReLU",
                 fdfwd_args: Optional[Dict[str, Any]] = None,
                 dropout: float = 0.1, dtype: torch.dtype = torch.float32):
        super().__init__()
        if fdfwd_type not in ("linear", "conv"):
            raise NotImplementedError(f"fdfwd_type {fdfwd_type!r}")
        get_activation(fdfwd_activation)           # validate the name
        self.fdfwd_type = fdfwd_type
        self.activation = fdfwd_activation
        self.dropout = dropout
        self.dtype = dtype
        if fdfwd_type == "conv":
            ks = int((fdfwd_args or {}).get("kernel_size", 3))
            self.in_layer = Conv1d(d_model, fdfwd_dim, ks, dtype=dtype)
            self.out_layer = Conv1d(fdfwd_dim, d_model, ks, dtype=dtype)
            return
        self.in_layer = Dense(d_model, fdfwd_dim, dtype=dtype,
                              bias_dtype=torch.float32)
        self.out_layer = Dense(fdfwd_dim, d_model, dtype=dtype,
                               bias_dtype=torch.float32)

    def forward(self, x: torch.Tensor,
                residual: Optional[torch.Tensor] = None,
                res_scale: float = 1.0,
                res_dropout: float = 0.0) -> torch.Tensor:
        """``[residual + res_scale * resdrop] ffn(x)`` in the compute
        dtype; dropout only in training mode."""
        cd = self.dtype
        train = self.training
        if self.fdfwd_type == "conv":
            h = get_activation(self.activation)(self.in_layer(x))
            out = self.out_layer(dropout(h, self.dropout, train))
            if residual is None:
                return out
            return residual + res_scale * dropout(out, res_dropout, train)
        rate = self.dropout if train and self.dropout > 0.0 else 0.0
        rrate = (res_dropout if train and res_dropout > 0.0
                 and residual is not None else 0.0)
        seed = draw_seed() if rate > 0.0 else 0
        rseed = draw_seed() if rrate > 0.0 else 0
        return cuda_ffn(x.to(cd), self.in_layer.weight, self.in_layer.bias,
                        self.out_layer.weight, self.out_layer.bias,
                        self.activation,
                        None if residual is None else residual.to(cd),
                        res_scale, rate, rrate, seed, rseed)
