"""Multi-head attention, absolute and relative-position variants
(counterpart of ``speechain_tpu/nn/attention.py``).

Parity notes (reference attention.py:16-133):
- DEFAULT SCALING IS NON-STANDARD: scores are scaled by 1/sqrt(d_model)
  unless ``scale_dp_by_head=True`` (then 1/sqrt(head_size)). Preserved.
- masked scores are filled with finfo(float32).min, not -inf: a fully
  masked row softmaxes to a finite uniform distribution.
- masks are boolean, True = attendable; shapes (B, 1, Tk) or (B, Tq, Tk).

:class:`MultiHeadedAttention` carries the full-sequence path (training
and teacher forcing), the single-step KV-cached self-attention
(``decode_step``) and cross-attention over encoder K/V projected once
(``project_kv`` at priming, ``attend_cached`` at every step). The
full-sequence path routes to the flash-attention kernel
(``ops/cuda_flash_attention.py``) where the reference routes to its Pallas
kernel (``_flash_eligible``, attention.py:52-70): no attention matrix
asked for, a key-style mask (None or (B, 1, Tk)), and no causal
attention with Tq != Tk. The reference's ``MAX_T`` cap is not carried
over: the CUDA kernels stream tiles and take any length. Attention dropout
(training mode) is drawn inside the kernel from a seed of the step's
generator (``ops/dropout.py``). Elsewhere scores and softmax are float32
over operands in the compute dtype, as in the reference's XLA path.

:class:`RelPosMultiHeadedAttention` is the conformer encoder's
self-attention; its core runs in the CUDA kernels
(``ops/cuda_attention.py``, forward and backward) for a tensor on the
card, with attention dropout drawn inside the kernel from a seed of the
step's generator in training, as the reference's ``_flash_seed``
(attention.py:73-80). A (B, T, T) mask, which the reference sends to XLA,
takes a plain composition of its XLA path instead (a route by the mask's
shape, as the reference's).
"""

from __future__ import annotations

import math
from typing import Optional, Tuple

import torch
from torch import nn

from speechain_tpu_torch.nn.dense import Dense
from speechain_tpu_torch.ops import dropout as drop
from speechain_tpu_torch.ops.cuda_attention import (NEG_FILL,
                                                    cuda_relpos_attention,
                                                    rel_shift)
from speechain_tpu_torch.ops.cuda_flash_attention import flash_attention
from speechain_tpu_torch.utils.masks import subsequent_mask

__all__ = ["MultiHeadedAttention", "RelPosMultiHeadedAttention", "rel_shift"]


class MultiHeadedAttention(nn.Module):
    def __init__(self, d_model: int, num_heads: int, dropout: float = 0.1,
                 scale_dp_by_head: bool = False,
                 dtype: torch.dtype = torch.float32,
                 kv_dim: Optional[int] = None):
        """``kv_dim``: the key / value inputs' width where it differs from
        ``d_model`` (a decoder's cross-attention over a wider encoder)."""
        super().__init__()
        if d_model % num_heads:
            raise ValueError("d_model must be a multiple of num_heads")
        self.d_model, self.num_heads = d_model, num_heads
        self.head_size = d_model // num_heads
        self.dtype = dtype
        self.dropout = dropout
        self.scale = (1.0 / math.sqrt(self.head_size) if scale_dp_by_head
                      else 1.0 / math.sqrt(d_model))
        for name in ("q_layer", "k_layer", "v_layer", "output_layer"):
            width = ((kv_dim or d_model) if name in ("k_layer", "v_layer")
                     else d_model)
            setattr(self, name, Dense(width, d_model, dtype=dtype))

    def _split(self, x: torch.Tensor) -> torch.Tensor:
        B, T = x.shape[0], x.shape[1]
        return x.reshape(B, T, self.num_heads,
                         self.head_size).transpose(1, 2)

    def project_kv(self, k: torch.Tensor, v: torch.Tensor
                   ) -> Tuple[torch.Tensor, torch.Tensor]:
        """Head-split K/V projections (B, H, Tk, Dh) in the compute dtype."""
        return self._split(self.k_layer(k)), self._split(self.v_layer(v))

    def _rate(self) -> float:
        return self.dropout if self.training and self.dropout > 0.0 else 0.0

    def attend_cached(self, q: torch.Tensor, kh: torch.Tensor,
                      vh: torch.Tensor, mask: Optional[torch.Tensor]):
        """Attention of q (B, Tq, D) over projected K/V; returns
        (output (B, Tq, D), attmat (B, H, Tq, Tk) float32)."""
        qh = self._split(self.q_layer(q))
        scores = (qh.float() @ kh.float().transpose(-1, -2)) * self.scale
        if mask is not None:
            scores = scores.masked_fill(~mask[:, None], NEG_FILL)
        attmat = torch.softmax(scores, dim=-1)
        att = attmat.to(self.dtype)
        if self.training:
            att = drop.dropout(att, self._rate(), True)
        ctx = (att.float() @ vh.float()).to(self.dtype)
        B, H, Tq, Dh = ctx.shape
        ctx = ctx.transpose(1, 2).reshape(B, Tq, H * Dh)
        return self.output_layer(ctx), attmat

    def forward(self, q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                mask: Optional[torch.Tensor] = None, causal: bool = False,
                return_attmat: bool = True):
        """Full-sequence attention; returns (output, attmat), attmat None
        on the kernel path. mask bool (B, 1|Tq, Tk), True = attendable."""
        if (not return_attmat and (mask is None or mask.shape[1] == 1)
                and not (causal and q.shape[1] != k.shape[1])):
            qf, kf, vf = self.q_layer(q), self.k_layer(k), self.v_layer(v)
            rate = self._rate()
            seed = drop.draw_seed() if rate > 0.0 else 0
            ctx = flash_attention(qf, kf, vf, self.scale, self.num_heads,
                                  causal, rate, seed,
                                  None if mask is None else mask[:, 0])
            return self.output_layer(ctx), None
        kh, vh = self.project_kv(k, v)
        if causal:
            cm = subsequent_mask(q.shape[1], device=q.device)
            mask = cm if mask is None else (mask & cm)
        return self.attend_cached(q, kh, vh, mask)

    def decode_step(self, x: torch.Tensor, cache_k: torch.Tensor,
                    cache_v: torch.Tensor, index: int) -> torch.Tensor:
        """Single-step KV-cached self-attention: x (B, 1, D). Writes this
        step's K/V at ``index`` of the (B, H, cap, Dh) caches in place and
        attends positions <= index."""
        kh, vh = self.project_kv(x, x)
        cache_k[:, :, index:index + 1] = kh
        cache_v[:, :, index:index + 1] = vh
        cap = cache_k.shape[2]
        mask = (torch.arange(cap, device=x.device) <= index)[None, None, :]
        out, _ = self.attend_cached(x, cache_k, cache_v, mask)
        return out


class RelPosMultiHeadedAttention(nn.Module):
    """Relative-position MHA (Transformer-XL, conformer/attention.py:7).

    ``posenc`` (1, 2T-1, D) covers relative positions [T-1 .. -(T-1)];
    learned pos_bias_u/v (H, Dh) are added to the queries."""

    def __init__(self, d_model: int, num_heads: int, dropout: float = 0.1,
                 scale_dp_by_head: bool = False,
                 dtype: torch.dtype = torch.float32):
        super().__init__()
        self.d_model, self.num_heads = d_model, num_heads
        self.head_size = d_model // num_heads
        self.dtype = dtype
        self.dropout = dropout
        self.scale = (1.0 / math.sqrt(self.head_size) if scale_dp_by_head
                      else 1.0 / math.sqrt(d_model))
        for name in ("q_layer", "k_layer", "v_layer", "output_layer"):
            setattr(self, name, Dense(d_model, d_model, dtype=dtype))
        self.pos_layer = Dense(d_model, d_model, bias=False, dtype=dtype)
        self.pos_bias_u = nn.Parameter(torch.zeros(num_heads,
                                                   self.head_size))
        self.pos_bias_v = nn.Parameter(torch.zeros(num_heads,
                                                   self.head_size))

    def forward(self, x: torch.Tensor, mask: Optional[torch.Tensor],
                posenc: torch.Tensor) -> torch.Tensor:
        """x (B, T, D); mask bool (B, 1, T) key mask, (B, T, T) or None;
        posenc (1, 2T-1, D). Returns (B, T, D). A key mask (or None) takes
        the kernels; a (B, T, T) mask (the causal conformer's) takes the
        plain composition, where the reference leaves its Pallas kernel
        for XLA (``_flash_eligible``, attention.py:68)."""
        if posenc.shape[1] != 2 * x.shape[1] - 1:
            raise ValueError("posenc must cover relative positions "
                             "[T-1 .. -(T-1)]")
        qf, kf, vf = self.q_layer(x), self.k_layer(x), self.v_layer(x)
        pf = self.pos_layer(posenc)[0]
        rate = self.dropout if self.training and self.dropout > 0.0 else 0.0
        if mask is not None and mask.shape[1] != 1:
            return self.output_layer(self._composed(qf, kf, vf, pf, mask,
                                                    rate))
        km = None if mask is None else mask[:, 0]
        seed = drop.draw_seed() if rate > 0.0 else 0
        ctx = cuda_relpos_attention(
            qf, kf, vf, pf, self.pos_bias_u.float().reshape(-1),
            self.pos_bias_v.float().reshape(-1), self.scale, self.num_heads,
            km, rate, seed)
        return self.output_layer(ctx)

    def _composed(self, qf, kf, vf, pf, mask, rate: float) -> torch.Tensor:
        """The reference's XLA path (attention.py:493-520): float32 scores
        (q + u) k^T + rel_shift((q + v) p^T) over operands in the compute
        dtype, scaled, masked with finfo(float32).min, softmax, dropout on
        the matrix in the compute dtype, float32 products with v."""
        B, T, D = qf.shape
        H, Dh = self.num_heads, self.head_size

        def split(t):
            return t.reshape(t.shape[0], -1, H, Dh).transpose(1, 2)

        qh, kh, vh = split(qf), split(kf), split(vf)
        ph = split(pf[None])                           # (1, H, 2T-1, Dh)
        q_u = qh + self.pos_bias_u[None, :, None].to(qh.dtype)
        q_v = qh + self.pos_bias_v[None, :, None].to(qh.dtype)
        ac = q_u.float() @ kh.float().transpose(-1, -2)
        bd = rel_shift(q_v.float() @ ph.float().transpose(-1, -2))
        scores = (ac + bd) * self.scale
        scores = scores.masked_fill(~mask[:, None], NEG_FILL)
        att = torch.softmax(scores, dim=-1).to(self.dtype)
        att = drop.dropout(att, rate, True)
        ctx = (att.float() @ vh.float()).to(self.dtype)
        return ctx.transpose(1, 2).reshape(B, T, D)
