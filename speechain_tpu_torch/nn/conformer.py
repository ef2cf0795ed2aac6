"""Conformer encoder, evaluation and training paths (counterpart of
``speechain_tpu/nn/conformer.py``).

Macaron FFN halves (0.5 * drop(ffn(x)) + x), rel-pos MHA, convolution
module, each residual with its own LayerNorm (pre- or post-LN), and a
final LayerNorm in pre-LN mode. In training (the module's ``training``
flag) every dropout of the reference applies: positional (both outputs of
the rel-pos encoding), attention (inside the rel-pos kernel), the FFN's
inner and residual dropout (inside the FFN kernel, at ``res_scale`` 0.5),
and residual ``FlatDropout`` on the attention and conv-module outputs
(reference :282-356). The causal variant (``uni_direction``) trains and
runs offline: the causal band is ANDed into the mask (:429-434), so the
rel-pos attention takes its plain composition (the reference's XLA
route for such masks), and the convolution modules are causal; the
chunked streaming decode mode (:238-280, :411-420) is not ported.

Convolution module (reference encoder.py:14-65): pointwise conv -> GLU ->
'SAME' depthwise conv -> BatchNorm -> SiLU -> pointwise conv. The front
half up to the depthwise output is one fused kernel with its backward
(``ops/cuda_convmod.py``). In evaluation BatchNorm uses the running
statistics and the kernel's per-channel sums go unused; in training it
normalises with the batch moments s / n, ss / n from the kernel's sums
(``BatchNorm.from_moments``, the reference's ``_BNApply``, :137-175), so
their gradients reach the kernel's backward. A causal module never takes
the kernel (the reference's gate, :205): its depthwise conv is left-padded
by K - 1 (:61-62), so frame t sees frames <= t, and it runs the
reference's unfused composition (pointwise conv, GLU, depthwise conv,
BatchNorm over every position) in plain PyTorch, the depthwise conv in
float32 as the kernel path's.
"""

from __future__ import annotations

from typing import Any, Dict, Optional

import torch
import torch.nn.functional as F
from torch import nn

from speechain_tpu_torch.nn.attention import RelPosMultiHeadedAttention
from speechain_tpu_torch.nn.dense import Dense
from speechain_tpu_torch.nn.feed_forward import PositionwiseFeedForward
from speechain_tpu_torch.nn.norms import BatchNorm, FlatDropout, LayerNorm
from speechain_tpu_torch.nn.posenc import RelPositionalEncoding
from speechain_tpu_torch.ops.cuda_convmod import cuda_conv_glu_dw
from speechain_tpu_torch.utils.masks import subsequent_mask


class ConvolutionModule(nn.Module):
    """Parameters as the kernel path of the reference uses them:
    pointwise_conv1 weight (2C, C), bias (2C,) and the depthwise bias in the
    compute dtype (or float32 master weights, rounded at use); the
    depthwise kernel (C, 1, K) in float32; pointwise_conv2 weight (C, C) in
    the compute dtype with a float32 bias."""

    def __init__(self, channels: int, depthwise_kernel_size: int = 31,
                 dtype: torch.dtype = torch.float32,
                 bn_axis_name: Optional[str] = None, causal: bool = False):
        super().__init__()
        C, K = channels, depthwise_kernel_size
        self.dtype = dtype
        self.causal = causal
        self.pointwise_conv1 = Dense(C, 2 * C, dtype=dtype)
        self.depthwise_conv = nn.Module()
        self.depthwise_conv.weight = nn.Parameter(torch.zeros(C, 1, K))
        self.depthwise_conv.bias = nn.Parameter(torch.zeros(C, dtype=dtype))
        self.batch_norm = BatchNorm(C, epsilon=1e-5, dtype=dtype)
        self.pointwise_conv2 = Dense(C, C, dtype=dtype,
                                     bias_dtype=torch.float32)

    def forward(self, feat: torch.Tensor) -> torch.Tensor:
        cd = self.dtype
        if self.causal:
            x = F.silu(self.batch_norm(self._causal_front(feat)))
        else:
            u, s, ss = cuda_conv_glu_dw(
                feat.to(cd), self.pointwise_conv1.weight,
                self.pointwise_conv1.bias, self.depthwise_conv.weight,
                self.depthwise_conv.bias)
            x = F.silu(self.batch_norm.from_moments(
                u, s, ss, feat.shape[0] * feat.shape[1]))
        pw = self.pointwise_conv2
        y = F.linear(x, pw.weight.to(cd)).float() + pw.bias
        return y.to(cd)

    def _causal_front(self, feat: torch.Tensor) -> torch.Tensor:
        """Pointwise conv (float32 bias add), GLU, and the depthwise conv
        over [K - 1 zero frames | x] in float32, in the compute dtype."""
        cd = self.dtype
        pw = self.pointwise_conv1
        y = (F.linear(feat.to(cd), pw.weight.to(cd)).float()
             + pw.bias.float()).to(cd)
        x = F.glu(y, dim=-1).float().transpose(1, 2)        # (B, C, T)
        dw = self.depthwise_conv
        K = dw.weight.shape[-1]
        x = F.conv1d(F.pad(x, (K - 1, 0)), dw.weight.float(),
                     dw.bias.float(), groups=x.shape[1])
        return x.transpose(1, 2).to(cd)


class ConformerEncoderLayer(nn.Module):
    def __init__(self, d_model: int = 512, num_heads: int = 8,
                 att_dropout: float = 0.1, depthwise_kernel_size: int = 31,
                 fdfwd_dim: int = 2048, fdfwd_type: str = "linear",
                 fdfwd_activation: str = "ReLU",
                 fdfwd_args: Optional[Dict[str, Any]] = None,
                 fdfwd_dropout: float = 0.1, res_dropout: float = 0.1,
                 layernorm_first: bool = True, scale_dp_by_head: bool = False,
                 dtype: torch.dtype = torch.float32,
                 bn_axis_name: Optional[str] = None, causal: bool = False,
                 fused_ln: Optional[bool] = None):
        super().__init__()
        self.layernorm_first = layernorm_first
        self.res_dropout = res_dropout

        def ffn():
            return PositionwiseFeedForward(
                d_model, fdfwd_dim, fdfwd_type, fdfwd_activation, fdfwd_args,
                dropout=fdfwd_dropout, dtype=dtype)

        self.drop = FlatDropout(res_dropout)
        self.front_fdfwd_layernorm = LayerNorm(d_model, fused=fused_ln)
        self.front_feed_forward = ffn()
        self.mha_layernorm = LayerNorm(d_model, fused=fused_ln)
        self.relpos_mha = RelPosMultiHeadedAttention(
            d_model, num_heads, att_dropout,
            scale_dp_by_head=scale_dp_by_head, dtype=dtype)
        self.conv_layernorm = LayerNorm(d_model, fused=fused_ln)
        self.conv_module = ConvolutionModule(d_model, depthwise_kernel_size,
                                             dtype=dtype, causal=causal)
        self.rear_fdfwd_layernorm = LayerNorm(d_model, fused=fused_ln)
        self.rear_feed_forward = ffn()

    def forward(self, src: torch.Tensor, mask: Optional[torch.Tensor],
                posenc: torch.Tensor) -> torch.Tensor:
        pre = self.layernorm_first
        x = self.front_fdfwd_layernorm(src) if pre else src
        x = self.front_feed_forward(x, residual=src, res_scale=0.5,
                                    res_dropout=self.res_dropout)
        if not pre:
            x = self.front_fdfwd_layernorm(x)

        y = self.mha_layernorm(x) if pre else x
        y = self.drop(self.relpos_mha(y, mask, posenc)) + x
        if not pre:
            y = self.mha_layernorm(y)

        z = self.conv_layernorm(y) if pre else y
        z = self.drop(self.conv_module(z)) + y
        if not pre:
            z = self.conv_layernorm(z)

        w = self.rear_fdfwd_layernorm(z) if pre else z
        w = self.rear_feed_forward(w, residual=z, res_scale=0.5,
                                   res_dropout=self.res_dropout)
        if not pre:
            w = self.rear_fdfwd_layernorm(w)
        return w


class ConformerEncoder(nn.Module):
    """Rel-posenc + N conformer layers (+ final LN in pre-LN mode).

    ``forward(src, mask)`` returns (output, mask); with ``uni_direction``
    the mask returned has the causal mask ANDed in, as the reference's."""

    def __init__(self, d_model: int = 512, num_heads: int = 8,
                 num_layers: int = 16, att_dropout: float = 0.1,
                 posenc_maxlen: int = 5000, posenc_dropout: float = 0.1,
                 depthwise_kernel_size: int = 31, fdfwd_dim: int = 2048,
                 fdfwd_type: str = "linear", fdfwd_activation: str = "SiLU",
                 fdfwd_args: Optional[Dict[str, Any]] = None,
                 fdfwd_dropout: float = 0.1, res_dropout: float = 0.1,
                 layernorm_first: bool = True, scale_dp_by_head: bool = False,
                 dtype: torch.dtype = torch.float32,
                 bn_axis_name: Optional[str] = None, remat: bool = False,
                 uni_direction: bool = False,
                 fused_ln: Optional[bool] = None):
        super().__init__()
        self.uni_direction = uni_direction
        self.num_layers = num_layers
        self.layernorm_first = layernorm_first
        self.posenc = RelPositionalEncoding(d_model, dropout=posenc_dropout,
                                            max_len=posenc_maxlen)
        for i in range(num_layers):
            self.add_module(f"layer_{i}", ConformerEncoderLayer(
                d_model, num_heads, att_dropout, depthwise_kernel_size,
                fdfwd_dim, fdfwd_type, fdfwd_activation, fdfwd_args,
                fdfwd_dropout, res_dropout, layernorm_first,
                scale_dp_by_head, dtype, causal=uni_direction,
                fused_ln=fused_ln))
        self.layernorm = (LayerNorm(d_model, fused=fused_ln)
                          if layernorm_first else None)

    def forward(self, src: torch.Tensor, mask: Optional[torch.Tensor]):
        src, posenc = self.posenc(src)
        if self.uni_direction:
            cm = subsequent_mask(src.shape[1], device=src.device)
            mask = cm if mask is None else (mask & cm)
        for i in range(self.num_layers):
            src = getattr(self, f"layer_{i}")(src, mask, posenc)
        if self.layernorm is not None:
            src = self.layernorm(src)
        return src, mask
