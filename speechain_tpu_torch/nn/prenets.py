"""Prenets on the ASR path (counterpart of ``speechain_tpu/nn/prenets.py``):
token embedding and the Conv2d downsampling prenet. In training mode the
prenet's BatchNorms normalize with the batch statistics and update their
running ones (the reference's unfused path, prenets.py:399-428).

The JAX prenet is channels-last (B, T, F, C); the port runs its convs
channels-first (B, C, T, F) as PyTorch does and flattens back to
(B, T', F' * C) in the reference's order. The fused prenet core
(``speechain_tpu/ops/pallas_prenet.py``) is off by default in the
reference and is not on this path.
"""

from __future__ import annotations

import math
from typing import Optional, Sequence, Union

import torch
import torch.nn.functional as F
from torch import nn

from speechain_tpu_torch.nn.dense import Dense
from speechain_tpu_torch.nn.feed_forward import get_activation
from speechain_tpu_torch.nn.norms import BatchNorm, bn_norm


def _as_list(x, n=None):
    if isinstance(x, (list, tuple)):
        return list(x)
    return [x] * (n if n is not None else 1)


def _pair(x):
    return tuple(x) if isinstance(x, (list, tuple)) else (x, x)


class EmbedPrenet(nn.Module):
    """Token embedding with optional sqrt(d) scale; ``padding_idx`` rows
    come out as zeros (prenet/embed.py:14-66)."""

    def __init__(self, vocab_size: int, embedding_dim: int,
                 scale: bool = False, emb_scale: Optional[bool] = None,
                 padding_idx: Optional[int] = 0,
                 dtype: torch.dtype = torch.float32):
        super().__init__()
        self.embed = nn.Module()
        self.embed.weight = nn.Parameter(torch.zeros(vocab_size,
                                                     embedding_dim,
                                                     dtype=dtype))
        self.padding_idx = padding_idx
        self.scale = scale if emb_scale is None else emb_scale
        self.embedding_dim = embedding_dim
        self.dtype = dtype

    def forward(self, text: torch.Tensor) -> torch.Tensor:
        emb = F.embedding(text.long(), self.embed.weight.to(self.dtype))
        if self.padding_idx is not None:
            emb = emb.masked_fill((text == self.padding_idx)[..., None], 0.0)
        if self.scale:
            emb = emb * math.sqrt(self.embedding_dim)
        return emb


class LinearPrenet(nn.Module):
    """Stacked Linear(+activation) blocks (prenet/linear.py:18-128)."""

    def __init__(self, in_features: int, lnr_dims, lnr_activation="ReLU",
                 lnr_dropout=None, zero_centered: bool = False,
                 dtype: torch.dtype = torch.float32):
        super().__init__()
        self.dims = _as_list(lnr_dims)
        self.act = lnr_activation
        self.zero_centered = zero_centered
        prev = in_features
        for i, d in enumerate(self.dims):
            self.add_module(f"linear_{i}", Dense(prev, d, dtype=dtype))
            prev = d

    def forward(self, feat: torch.Tensor) -> torch.Tensor:
        for i in range(len(self.dims)):
            feat = getattr(self, f"linear_{i}")(feat)
            if self.act is not None:
                last = i == len(self.dims) - 1
                if not (last and self.zero_centered and "ReLU" in self.act):
                    feat = get_activation(self.act)(feat)
        return feat


class Conv2dPrenet(nn.Module):
    """2-D conv downsampling + linear projection, the ASR-encoder prenet
    (prenet/conv2d.py:15-280). Input (B, T, F) is a 1-channel image; each
    block is conv (stride, no padding by default) [-> BatchNorm] -> act;
    output (B, T', C*F') is optionally projected. Length recurrence:
    len = (len - kernel_t) // stride_t + 1 per block."""

    def __init__(self, in_features: int,
                 conv_dims: Union[int, Sequence[int]] = (64, 64),
                 conv_kernel=3, conv_stride=2, conv_padding=0,
                 conv_batchnorm: bool = False,
                 conv_activation: Optional[str] = "ReLU",
                 conv_dropout=None, lnr_dims=512,
                 lnr_activation: Optional[str] = None, lnr_dropout=None,
                 zero_centered: bool = False,
                 dtype: torch.dtype = torch.float32,
                 bn_axis_name: Optional[str] = None):
        super().__init__()
        self.conv_dims = _as_list(conv_dims)
        self.kernel, self.stride = _pair(conv_kernel), _pair(conv_stride)
        self.pad = _pair(conv_padding)
        self.batchnorm = conv_batchnorm
        self.act = conv_activation
        self.zero_centered = zero_centered
        self.has_linear = lnr_dims is not None
        self.dtype = dtype
        cin, f = 1, in_features
        for i, dim in enumerate(self.conv_dims):
            conv = nn.Module()
            conv.weight = nn.Parameter(torch.zeros(dim, cin, *self.kernel,
                                                   dtype=dtype))
            conv.bias = (None if conv_batchnorm else
                         nn.Parameter(torch.zeros(dim, dtype=dtype)))
            self.add_module(f"conv_{i}", conv)
            if conv_batchnorm:
                self.add_module(f"batchnorm_{i}",
                                BatchNorm(dim, epsilon=1e-5, dtype=dtype))
            cin = dim
            f = (f + 2 * self.pad[1] - self.kernel[1]) // self.stride[1] + 1
        if self.has_linear:
            self.linear = LinearPrenet(cin * f, lnr_dims, lnr_activation,
                                       zero_centered=zero_centered,
                                       dtype=dtype)

    def out_len(self, feat_len: torch.Tensor) -> torch.Tensor:
        for _ in self.conv_dims:
            feat_len = ((feat_len + 2 * self.pad[0] - self.kernel[0])
                        // self.stride[0] + 1)
        return feat_len

    def forward(self, feat: torch.Tensor, feat_len: torch.Tensor):
        x = feat.to(self.dtype)[:, None]                 # (B, 1, T, F)
        n = len(self.conv_dims)
        for i in range(n):
            conv = getattr(self, f"conv_{i}")
            x = F.conv2d(x, conv.weight.to(self.dtype),
                         None if conv.bias is None
                         else conv.bias.to(self.dtype),
                         stride=self.stride, padding=self.pad)
            if self.batchnorm:
                bn = getattr(self, f"batchnorm_{i}")
                mean, var = bn.statistics(x, (0, 2, 3))
                view = (-1, 1, 1)
                x = bn_norm(x, mean.view(view), var.view(view),
                            bn.weight.float().view(view),
                            bn.bias.float().view(view),
                            bn.epsilon).to(self.dtype)
            if self.act is not None:
                last = i == n - 1 and not self.has_linear
                if not (last and self.zero_centered and "ReLU" in self.act):
                    x = get_activation(self.act)(x)
        B, C, T2, F2 = x.shape
        feat = x.permute(0, 2, 3, 1).reshape(B, T2, F2 * C)
        feat_len = self.out_len(feat_len)
        if self.has_linear:
            feat = self.linear(feat)
        return feat, feat_len
