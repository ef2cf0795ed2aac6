"""Postnets (counterpart of ``speechain_tpu/nn/postnets.py``): the token
postnet, a linear projection to vocabulary logits (postnet/token.py:12-48),
and the TTS models' Tacotron2-style Conv1d mel postnet
(postnet/conv1d.py:15-166, reference postnets.py:36)."""

from __future__ import annotations

from typing import Sequence, Union

import torch
from torch import nn

from speechain_tpu_torch.nn.dense import Dense
from speechain_tpu_torch.nn.feed_forward import get_activation
from speechain_tpu_torch.nn.norms import BatchNorm
from speechain_tpu_torch.nn.prenets import Conv1dEv, _as_list
from speechain_tpu_torch.ops.dropout import dropout


class TokenPostnet(nn.Module):
    def __init__(self, d_model: int, vocab_size: int,
                 dtype: torch.dtype = torch.float32):
        super().__init__()
        self.linear = Dense(d_model, vocab_size, dtype=dtype)

    def forward(self, feat: torch.Tensor) -> torch.Tensor:
        return self.linear(feat)


class Conv1dPostnet(nn.Module):
    """The residual mel refinement: [Conv1d -> BatchNorm -> Tanh ->
    Dropout] x (N - 1) -> Conv1d(feat_dim) -> BatchNorm -> Dropout over
    (B, T, feat_dim); the caller adds the output to the coarse prediction.
    In evaluation the BatchNorms normalize with their running statistics
    (``nn/norms.py::BatchNorm``)."""

    def __init__(self, feat_dim: int,
                 conv_dims: Union[int, Sequence[int]] = (512,) * 5,
                 conv_kernel: int = 5, conv_batchnorm: bool = True,
                 conv_activation: str = "Tanh",
                 conv_dropout: Union[float, Sequence[float]] = 0.5,
                 dtype: torch.dtype = torch.float32):
        super().__init__()
        self.dims = list(_as_list(conv_dims)) + [feat_dim]
        self.drops = _as_list(conv_dropout, len(self.dims))
        self.batchnorm, self.act = conv_batchnorm, conv_activation
        cin = feat_dim
        for i, dim in enumerate(self.dims):
            self.add_module(f"conv_{i}", Conv1dEv(
                cin, dim, conv_kernel, padding_mode="same",
                use_bias=not conv_batchnorm, dtype=dtype))
            if conv_batchnorm:
                self.add_module(f"batchnorm_{i}",
                                BatchNorm(dim, epsilon=1e-5, dtype=dtype))
            cin = dim

    def forward(self, feat: torch.Tensor) -> torch.Tensor:
        x = feat
        for i in range(len(self.dims)):
            x = getattr(self, f"conv_{i}")(x)
            if self.batchnorm:
                x = getattr(self, f"batchnorm_{i}")(x)
            if i < len(self.dims) - 1 and self.act is not None:
                x = get_activation(self.act)(x)
            x = dropout(x, self.drops[i], self.training)
        return x
