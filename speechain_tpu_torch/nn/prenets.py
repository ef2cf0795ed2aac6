"""Prenets on the ASR path (counterpart of ``speechain_tpu/nn/prenets.py``):
token embedding and the Conv2d downsampling prenet. In training mode the
prenet's BatchNorms normalize with the batch statistics and update their
running ones (the reference's unfused path, prenets.py:399-428).

The JAX prenet is channels-last (B, T, F, C); the port runs its convs
channels-first (B, C, T, F) as PyTorch does and flattens back to
(B, T', F' * C) in the reference's order.

:class:`Conv2dPrenet` also has the reference's fused routes
(prenets.py:337-397, ``ops/cuda_prenet.py``), off by default as there:
``core="xla"`` (BatchNorm-1 folded into conv1, exact gradients) or
``core="fused"`` (the CUDA core, the reference's ``"pallas"``); the
default comes from ``SPEECHAIN_FORCE_FUSED_PRENET`` /
``SPEECHAIN_DISABLE_FUSED_PRENET`` / ``SPEECHAIN_DISABLE_PALLAS`` as in the
reference (``ops/cuda_prenet.py::prenet_core_impl``).
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
from speechain_tpu_torch.ops import cuda_prenet
from speechain_tpu_torch.ops.dropout import dropout


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
    """Stacked Linear(+activation+dropout) blocks (prenet/linear.py:18-128);
    in training each layer with a rate in ``lnr_dropout`` drops after its
    activation (the reference's flax ``Dropout``, ``nn/prenets.py:131-132``;
    masks from ``ops/dropout.py``)."""

    def __init__(self, in_features: int, lnr_dims, lnr_activation="ReLU",
                 lnr_dropout=None, zero_centered: bool = False,
                 dtype: torch.dtype = torch.float32):
        super().__init__()
        self.dims = _as_list(lnr_dims)
        self.act = lnr_activation
        self.drops = (_as_list(lnr_dropout, len(self.dims))
                      if lnr_dropout is not None
                      else [None] * len(self.dims))
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
            if self.drops[i] is not None:
                feat = dropout(feat, self.drops[i], self.training)
        return feat


FROM_ENV = "from_env"      # Conv2dPrenet(core=...): the reference's switch


class Conv2dPrenet(nn.Module):
    """2-D conv downsampling + linear projection, the ASR-encoder prenet
    (prenet/conv2d.py:15-280). Input (B, T, F) is a 1-channel image; each
    block is conv (stride, no padding by default) [-> BatchNorm] -> act;
    output (B, T', C*F') is optionally projected. Length recurrence:
    len = (len - kernel_t) // stride_t + 1 per block.

    ``core`` picks the route where the reference's gate
    (``_prenet_fused_impl``, prenets.py:259-279) allows a fused one: None
    (unfused), ``"xla"`` or ``"fused"``; the default reads the reference's
    environment variables. On a fused route (prenets.py:337-397) the
    BatchNorm-1 batch moments come analytically from the patch statistics
    (mean = S w1 / n1, E[x^2] = w1^T G w1 / n1, n1 = B U1 F1), turn into an
    affine (:meth:`BatchNorm.affine`) that the core applies before its
    activation, and BatchNorm-2, the activation (always, whatever
    ``zero_centered`` says, as the reference's fused route), the flatten
    and the linear layers follow. The fused core returns ZERO as the
    input's gradient (``ops/cuda_prenet.py``; its statistics see a
    detached input for the same reason): right only because nothing
    upstream of the prenet has parameters. The ``"xla"`` core's input
    gradients are exact.
    """

    def __init__(self, in_features: int,
                 conv_dims: Union[int, Sequence[int]] = (64, 64),
                 conv_kernel=3, conv_stride=2, conv_padding=0,
                 conv_batchnorm: bool = False,
                 conv_activation: Optional[str] = "ReLU",
                 conv_dropout=None, lnr_dims=512,
                 lnr_activation: Optional[str] = None, lnr_dropout=None,
                 zero_centered: bool = False,
                 dtype: torch.dtype = torch.float32,
                 bn_axis_name: Optional[str] = None,
                 core: Optional[str] = FROM_ENV):
        super().__init__()
        self.conv_dims = _as_list(conv_dims)
        self.kernel, self.stride = _pair(conv_kernel), _pair(conv_stride)
        self.pad = _pair(conv_padding)
        self.batchnorm = conv_batchnorm
        self.act = conv_activation
        self.drops = (_as_list(conv_dropout, len(self.conv_dims))
                      if conv_dropout is not None
                      else [None] * len(self.conv_dims))
        self.zero_centered = zero_centered
        self.has_linear = lnr_dims is not None
        self.dtype = dtype
        if core == FROM_ENV:
            core = cuda_prenet.prenet_core_impl()
        if core not in (None, "xla", "fused"):
            raise ValueError(f"Conv2dPrenet: core must be None, 'xla' or "
                             f"'fused', got {core!r}")
        self.core = core
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
                                       lnr_dropout=lnr_dropout,
                                       zero_centered=zero_centered,
                                       dtype=dtype)

    def out_len(self, feat_len: torch.Tensor) -> torch.Tensor:
        for _ in self.conv_dims:
            feat_len = ((feat_len + 2 * self.pad[0] - self.kernel[0])
                        // self.stride[0] + 1)
        return feat_len

    def fused_route(self, T: int, F: int) -> Optional[str]:
        """The route for a (B, T, F) input: ``core`` where the reference's
        gate (prenets.py:259-279) allows a fused one, else None."""
        dims = self.conv_dims
        if (self.core is None or len(dims) != 2 or dims[0] != dims[1]
                or dims[0] % 128 != 0 or self.kernel != (3, 3)
                or self.stride != (2, 2) or self.pad != (0, 0)
                or not self.batchnorm or any(d is not None
                                             for d in self.drops)
                or self.act is None):
            return None
        _, _, T2, F2 = cuda_prenet.geom(T, F)
        return self.core if T2 >= 2 and F2 >= 1 else None

    def forward(self, feat: torch.Tensor, feat_len: torch.Tensor):
        route = self.fused_route(feat.shape[1], feat.shape[2])
        if route is not None:
            x = self._fused(feat.to(self.dtype), route)
        else:
            x = self._unfused(feat.to(self.dtype))
        B, T2, F2, C = x.shape
        feat = x.reshape(B, T2, F2 * C)
        feat_len = self.out_len(feat_len)
        if self.has_linear:
            feat = self.linear(feat)
        return feat, feat_len

    def _unfused(self, x: torch.Tensor) -> torch.Tensor:
        """(B, T, F) -> (B, T2, F2, C) through the conv blocks; in training
        a block with a rate in ``conv_dropout`` drops after its activation
        step, over the reference's channels-last layout (``nn/prenets.py:
        415-416``)."""
        x = x[:, None]                                   # (B, 1, T, F)
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
            if self.drops[i] is not None:
                x = dropout(x.permute(0, 2, 3, 1), self.drops[i],
                            self.training).permute(0, 3, 1, 2)
        return x.permute(0, 2, 3, 1)

    def _fused(self, mel: torch.Tensor, route: str) -> torch.Tensor:
        """(B, T, F) in the compute dtype -> (B, T2, F2, C), activated
        after BatchNorm-2, on the fused route."""
        B, T, Fm = mel.shape
        U1, F1, _, _ = cuda_prenet.geom(T, Fm)
        C = self.conv_dims[0]
        w1 = self.conv_0.weight.float().reshape(C, 9).t()     # (9, C)
        w2 = self.conv_1.weight.float().permute(2, 3, 1, 0).reshape(9, C, C)
        bn1 = self.batchnorm_0
        if bn1.training:
            M = cuda_prenet.build_patches_std(
                mel if route == "xla" else mel.detach())
            S, G = cuda_prenet.patch_stats_std(M)
            n1 = B * U1 * F1
            mean1 = (S @ w1) / n1
            mean2 = torch.einsum("jc,jk,kc->c", w1, G, w1) / n1
        else:
            mean1 = mean2 = None
        g1, b1 = bn1.affine(mean1, mean2)
        if route == "xla":
            x = cuda_prenet.xla_prenet_core(
                cuda_prenet.build_patches_std(mel), w1, g1, b1, w2, self.act)
        else:
            x = cuda_prenet.fused_prenet_core(mel, w1, g1, b1, w2, self.act)
        x = self.batchnorm_1(x)
        return get_activation(self.act)(x)
