"""Transformer encoder and decoder stacks (counterpart of
``speechain_tpu/nn/transformer.py``).

:class:`TransformerEncoder` (transformer.py:35-216): posenc, then N layers
of self-attention and FFN, each with its own LayerNorm (pre- or post-LN),
residual dropout on the attention output and the FFN's residual epilogue;
a final LayerNorm in pre-LN mode. With ``fdfwd_type: moe`` an encoder
layer's FFN is :class:`~speechain_tpu_torch.nn.moe.SwitchFFN`, with the
residual and its dropout outside it (transformer.py:72-82); the decoder
layer has no such branch, as the reference's has none.
``uni_direction`` passes causality to the attention as a flag over a
(B, 1, T) length mask, which keeps the flash-attention kernel on the
path, as the reference does. A causal
encoder (the language model's) also decodes one token a step over KV
caches (the reference's ``decode=True`` mode, transformer.py:148-203):
:meth:`TransformerEncoder.prime` allocates zeroed self-attention K/V of a
fixed capacity and writes nothing, and each
:meth:`TransformerEncoder.decode_step` adds posenc at the cache position,
writes that position's K/V, attends the cached prefix and advances the
position.

:class:`TransformerDecoder` has two paths. Teacher forcing
(:meth:`TransformerDecoder.forward`, transformer.py:319-390): causal
self-attention as a flag over the (B, 1, L) length mask, cross-attention
over the encoder output, FFN; both attentions go through the
flash-attention kernel, except those whose attention matrices the caller
asks for (``self_attmats`` / ``cross_attmats``: Transformer-TTS's
attention guidance reads layer 0's cross-attention), which take the
matrix path. KV-cached decoding: priming
(:meth:`TransformerDecoder.prime`) projects every layer's
cross-attention K/V from the encoder output once and allocates zeroed
self-attention K/V caches of a fixed capacity; the reference's priming
pass does the same and discards its output. Each
:meth:`TransformerDecoder.decode_step` embeds one token per row at the
cache position, writes that position's self-attention K/V, attends the
cached prefix and the cached encoder K/V, and advances the position.
"""

from __future__ import annotations

import dataclasses
from typing import Any, Dict, List, Optional, Sequence

import torch
from torch import nn

from speechain_tpu_torch.nn.attention import MultiHeadedAttention
from speechain_tpu_torch.nn.feed_forward import PositionwiseFeedForward
from speechain_tpu_torch.nn.moe import SwitchFFN
from speechain_tpu_torch.nn.norms import FlatDropout, LayerNorm
from speechain_tpu_torch.nn.posenc import PositionalEncoding
from speechain_tpu_torch.utils.masks import subsequent_mask


class TransformerEncoderLayer(nn.Module):
    def __init__(self, d_model: int, num_heads: int,
                 scale_dp_by_head: bool = False, att_dropout: float = 0.1,
                 fdfwd_dim: int = 2048, fdfwd_type: str = "linear",
                 fdfwd_activation: str = "ReLU",
                 fdfwd_args: Optional[Dict[str, Any]] = None,
                 fdfwd_dropout: float = 0.1, res_dropout: float = 0.1,
                 layernorm_first: bool = True,
                 dtype: torch.dtype = torch.float32,
                 fused_ln: Optional[bool] = None):
        super().__init__()
        self.layernorm_first = layernorm_first
        self.res_dropout = res_dropout
        self.att_layernorm = LayerNorm(d_model, fused=fused_ln)
        self.fdfwd_layernorm = LayerNorm(d_model, fused=fused_ln)
        self.multihead_att = MultiHeadedAttention(
            d_model, num_heads, att_dropout, scale_dp_by_head, dtype=dtype)
        self.moe = fdfwd_type == "moe"
        if self.moe:
            self.feed_forward = SwitchFFN(
                d_model, fdfwd_dim, fdfwd_activation=fdfwd_activation,
                dropout=fdfwd_dropout, dtype=dtype, **(fdfwd_args or {}))
        else:
            self.feed_forward = PositionwiseFeedForward(
                d_model, fdfwd_dim, fdfwd_type, fdfwd_activation,
                fdfwd_args, dropout=fdfwd_dropout, dtype=dtype)
        self.drop = FlatDropout(res_dropout)

    def forward(self, src: torch.Tensor, mask: Optional[torch.Tensor],
                causal: bool = False) -> torch.Tensor:
        pre = self.layernorm_first
        x = self.att_layernorm(src) if pre else src
        att_hidden, _ = self.multihead_att(x, x, x, mask, causal=causal,
                                           return_attmat=False)
        return self._ffn(self.drop(att_hidden) + src)

    def _ffn(self, att_out: torch.Tensor) -> torch.Tensor:
        pre = self.layernorm_first
        if not pre:
            att_out = self.att_layernorm(att_out)
        y = self.fdfwd_layernorm(att_out) if pre else att_out
        if self.moe:
            out = self.drop(self.feed_forward(y)) + att_out
        else:
            out = self.feed_forward(y, residual=att_out,
                                    res_dropout=self.res_dropout)
        if not pre:
            out = self.fdfwd_layernorm(out)
        return out

    def decode_step(self, src: torch.Tensor, cache: "EncoderCache",
                    i: int) -> torch.Tensor:
        x = self.att_layernorm(src) if self.layernorm_first else src
        return self._ffn(self.multihead_att.decode_step(
            x, cache.self_k[i], cache.self_v[i], cache.position) + src)


class TransformerEncoder(nn.Module):
    """Posenc + N encoder layers (+ final LN in pre-LN mode).

    ``forward(src, mask)`` returns (output, mask); with ``uni_direction``
    the mask returned has the causal mask ANDed in, as the reference's."""

    def __init__(self, d_model: int = 512, num_heads: int = 4,
                 num_layers: int = 8, scale_dp_by_head: bool = False,
                 att_dropout: float = 0.1, posenc_type: str = "mix",
                 posenc_maxlen: int = 5000, posenc_dropout: float = 0.1,
                 posenc_scale: bool = False, posenc_init_alpha: float = 1.0,
                 emb_layernorm: bool = False, emb_scale: bool = True,
                 fdfwd_dim: int = 2048, fdfwd_type: str = "linear",
                 fdfwd_activation: str = "ReLU",
                 fdfwd_args: Optional[Dict[str, Any]] = None,
                 fdfwd_dropout: float = 0.1, res_dropout: float = 0.1,
                 uni_direction: bool = False, layernorm_first: bool = True,
                 dtype: torch.dtype = torch.float32, remat: bool = False,
                 fused_ln: Optional[bool] = None):
        super().__init__()
        self.num_layers, self.num_heads = num_layers, num_heads
        self.head_size = d_model // num_heads
        self.dtype = dtype
        self.uni_direction = uni_direction
        self.posenc = PositionalEncoding(
            d_model, posenc_type, emb_layernorm, emb_scale, posenc_scale,
            posenc_init_alpha, dropout=posenc_dropout, max_len=posenc_maxlen)
        for i in range(num_layers):
            self.add_module(f"layer_{i}", TransformerEncoderLayer(
                d_model, num_heads, scale_dp_by_head, att_dropout, fdfwd_dim,
                fdfwd_type, fdfwd_activation, fdfwd_args, fdfwd_dropout,
                res_dropout, layernorm_first, dtype, fused_ln))
        self.layernorm = (LayerNorm(d_model, fused=fused_ln)
                          if layernorm_first else None)

    def forward(self, src: torch.Tensor, mask: Optional[torch.Tensor]):
        src = self.posenc(src)
        for i in range(self.num_layers):
            src = getattr(self, f"layer_{i}")(src, mask, self.uni_direction)
        if self.uni_direction:
            cm = subsequent_mask(src.shape[1], device=src.device)
            mask = cm if mask is None else (mask & cm)
        if self.layernorm is not None:
            src = self.layernorm(src)
        return src, mask

    def prime(self, batch: int, cache_capacity: int,
              device=None) -> "EncoderCache":
        """Zeroed self-attention K/V caches (batch, H, cache_capacity, Dh)
        of every layer in the net's dtype, at position 0."""
        if not self.uni_direction:
            raise ValueError("KV-cached decoding needs a causal encoder "
                             "(uni_direction=True)")
        shape = (batch, self.num_heads, cache_capacity, self.head_size)

        def zeros():
            return [torch.zeros(shape, dtype=self.dtype, device=device)
                    for _ in range(self.num_layers)]
        return EncoderCache(zeros(), zeros())

    def decode_step(self, src: torch.Tensor,
                    cache: "EncoderCache") -> torch.Tensor:
        """src (B, 1, D) at position ``cache.position``; advances the
        position by one. Returns the encoder output (B, 1, D)."""
        if cache.position >= cache.self_k[0].shape[2]:
            raise ValueError("encoder KV cache is full")
        src = self.posenc(src, offset=cache.position)
        for i in range(self.num_layers):
            src = getattr(self, f"layer_{i}").decode_step(src, cache, i)
        cache.position += 1
        if self.layernorm is not None:
            src = self.layernorm(src)
        return src


@dataclasses.dataclass
class EncoderCache:
    """Per-layer self-attention KV caches of a causal encoder, (B, H,
    cap, Dh) each, and the next write position shared by all rows."""

    self_k: List[torch.Tensor]
    self_v: List[torch.Tensor]
    position: int = 0

    def reorder(self, beam_idx: torch.Tensor) -> "EncoderCache":
        """Reindex every layer's K/V by a flat (B,) row index."""
        return EncoderCache(
            [k.index_select(0, beam_idx) for k in self.self_k],
            [v.index_select(0, beam_idx) for v in self.self_v],
            self.position)


@dataclasses.dataclass
class DecoderCache:
    """Per-layer KV caches of a decoder, (B, H, cap|T_enc, Dh) each, and
    the next write position shared by all rows."""

    self_k: List[torch.Tensor]
    self_v: List[torch.Tensor]
    cross_k: List[torch.Tensor]
    cross_v: List[torch.Tensor]
    position: int = 0

    def reorder(self, beam_idx: torch.Tensor) -> "DecoderCache":
        """Reindex the self-attention caches by a flat (B,) row index.

        The cross-attention K/V are left as they are: a beam reorder stays
        within an utterance's block of rows, all of which hold the same
        encoder K/V (infer/beam_search.py ``_gather_cache``)."""
        return DecoderCache(
            [k.index_select(0, beam_idx) for k in self.self_k],
            [v.index_select(0, beam_idx) for v in self.self_v],
            self.cross_k, self.cross_v, self.position)


class TransformerDecoderLayer(nn.Module):
    """Self-att (causal) + cross-att + FFN (decoder.py:16-176)."""

    def __init__(self, d_model: int, num_heads: int,
                 scale_dp_by_head: bool = False, att_dropout: float = 0.1,
                 fdfwd_dim: int = 2048, fdfwd_type: str = "linear",
                 fdfwd_activation: str = "ReLU",
                 fdfwd_args: Optional[Dict[str, Any]] = None,
                 fdfwd_dropout: float = 0.1, res_dropout: float = 0.1,
                 layernorm_first: bool = True,
                 dtype: torch.dtype = torch.float32,
                 fused_ln: Optional[bool] = None,
                 enc_dim: Optional[int] = None):
        super().__init__()
        self.layernorm_first = layernorm_first
        self.res_dropout = res_dropout
        self.self_att_layernorm = LayerNorm(d_model, fused=fused_ln)
        self.cross_att_layernorm = LayerNorm(d_model, fused=fused_ln)
        self.fdfwd_layernorm = LayerNorm(d_model, fused=fused_ln)
        self.self_att = MultiHeadedAttention(
            d_model, num_heads, att_dropout, scale_dp_by_head, dtype=dtype)
        self.cross_att = MultiHeadedAttention(
            d_model, num_heads, att_dropout, scale_dp_by_head, dtype=dtype,
            kv_dim=enc_dim)
        self.feed_forward = PositionwiseFeedForward(
            d_model, fdfwd_dim, fdfwd_type, fdfwd_activation, fdfwd_args,
            dropout=fdfwd_dropout, dtype=dtype)
        self.drop = FlatDropout(res_dropout)

    def forward(self, tgt: torch.Tensor, enc_feat: torch.Tensor,
                tgt_mask: Optional[torch.Tensor],
                src_mask: Optional[torch.Tensor], self_attmat: bool = False,
                cross_attmat: bool = False):
        """Teacher-forced pass: causal self-attention over the (B, 1, L)
        length mask ``tgt_mask``, cross-attention over ``enc_feat``.
        Returns the output; with ``self_attmat`` or ``cross_attmat``,
        (output, self-attention matrix, cross-attention matrix), each
        (B, H, L, T) float32 where asked for, else None: an attention
        whose matrix is asked for takes the matrix path
        (``MultiHeadedAttention.attend_cached``), the other the kernel."""
        pre = self.layernorm_first
        x = self.self_att_layernorm(tgt) if pre else tgt
        self_hidden, self_mat = self.self_att(x, x, x, tgt_mask, causal=True,
                                              return_attmat=self_attmat)
        self_out = self.drop(self_hidden) + tgt
        if not pre:
            self_out = self.self_att_layernorm(self_out)

        y = self.cross_att_layernorm(self_out) if pre else self_out
        cross_hidden, cross_mat = self.cross_att(
            y, enc_feat, enc_feat, src_mask, return_attmat=cross_attmat)
        cross_out = self.drop(cross_hidden) + self_out
        if not pre:
            cross_out = self.cross_att_layernorm(cross_out)

        z = self.fdfwd_layernorm(cross_out) if pre else cross_out
        out = self.feed_forward(z, residual=cross_out,
                                res_dropout=self.res_dropout)
        if not pre:
            out = self.fdfwd_layernorm(out)
        if self_attmat or cross_attmat:
            return out, self_mat, cross_mat
        return out

    def decode_step(self, tgt, cache: DecoderCache, i: int,
                    src_mask: Optional[torch.Tensor]) -> torch.Tensor:
        pre = self.layernorm_first
        x = self.self_att_layernorm(tgt) if pre else tgt
        self_out = self.self_att.decode_step(
            x, cache.self_k[i], cache.self_v[i], cache.position) + tgt
        if not pre:
            self_out = self.self_att_layernorm(self_out)

        y = self.cross_att_layernorm(self_out) if pre else self_out
        cross_hidden, _ = self.cross_att.attend_cached(
            y, cache.cross_k[i], cache.cross_v[i], src_mask)
        cross_out = cross_hidden + self_out
        if not pre:
            cross_out = self.cross_att_layernorm(cross_out)

        z = self.fdfwd_layernorm(cross_out) if pre else cross_out
        out = self.feed_forward(z, residual=cross_out)
        if not pre:
            out = self.fdfwd_layernorm(out)
        return out


class TransformerDecoder(nn.Module):
    """Posenc + N decoder layers (+ final LN in pre-LN mode). ``enc_dim``:
    the encoder output's width where it differs from ``d_model`` (the
    cross-attention's key / value inputs; flax infers it)."""

    def __init__(self, d_model: int = 512, num_heads: int = 4,
                 num_layers: int = 8, scale_dp_by_head: bool = False,
                 att_dropout: float = 0.1, posenc_type: str = "mix",
                 posenc_maxlen: int = 5000, posenc_dropout: float = 0.1,
                 posenc_scale: bool = False, posenc_init_alpha: float = 1.0,
                 emb_layernorm: bool = False, emb_scale: bool = True,
                 fdfwd_dim: int = 2048, fdfwd_type: str = "linear",
                 fdfwd_activation: str = "ReLU",
                 fdfwd_args: Optional[Dict[str, Any]] = None,
                 fdfwd_dropout: float = 0.1, res_dropout: float = 0.1,
                 layernorm_first: bool = True,
                 dtype: torch.dtype = torch.float32, remat: bool = False,
                 fused_ln: Optional[bool] = None,
                 enc_dim: Optional[int] = None):
        super().__init__()
        self.num_layers, self.num_heads = num_layers, num_heads
        self.head_size = d_model // num_heads
        self.dtype = dtype
        self.posenc = PositionalEncoding(
            d_model, posenc_type, emb_layernorm, emb_scale, posenc_scale,
            posenc_init_alpha, dropout=posenc_dropout, max_len=posenc_maxlen)
        for i in range(num_layers):
            self.add_module(f"layer_{i}", TransformerDecoderLayer(
                d_model, num_heads, scale_dp_by_head, att_dropout, fdfwd_dim,
                fdfwd_type, fdfwd_activation, fdfwd_args, fdfwd_dropout,
                res_dropout, layernorm_first, dtype, fused_ln, enc_dim))
        self.layernorm = (LayerNorm(d_model, fused=fused_ln)
                          if layernorm_first else None)

    def _layers(self):
        return [getattr(self, f"layer_{i}") for i in range(self.num_layers)]

    def forward(self, tgt_emb: torch.Tensor, enc_feat: torch.Tensor,
                tgt_mask: Optional[torch.Tensor],
                src_mask: Optional[torch.Tensor],
                self_attmats: Sequence[int] = (),
                cross_attmats: Sequence[int] = ()):
        """Teacher-forced pass over the whole target: tgt_emb (B, L, D),
        tgt_mask (B, 1, L) length mask (causality is a flag), src_mask
        (B, 1, T_enc). Returns (B, L, D); with layer indices in
        ``self_attmats`` or ``cross_attmats``, (output, the self-attention
        matrices, the cross-attention matrices) of those layers, in layer
        order (transformer.py:376-386 returns every layer's)."""
        tgt = self.posenc(tgt_emb)
        self_mats, cross_mats = [], []
        for i, layer in enumerate(self._layers()):
            want_self, want_cross = i in self_attmats, i in cross_attmats
            if not (want_self or want_cross):
                tgt = layer(tgt, enc_feat, tgt_mask, src_mask)
                continue
            tgt, sa, ca = layer(tgt, enc_feat, tgt_mask, src_mask,
                                want_self, want_cross)
            if want_self:
                self_mats.append(sa)
            if want_cross:
                cross_mats.append(ca)
        if self.layernorm is not None:
            tgt = self.layernorm(tgt)
        if self_attmats or cross_attmats:
            return tgt, self_mats, cross_mats
        return tgt

    def prime(self, enc_feat: torch.Tensor,
              cache_capacity: int) -> DecoderCache:
        """Cross-attention K/V of every layer and zeroed self-attention
        caches of ``cache_capacity`` positions for enc_feat's rows."""
        B = enc_feat.shape[0]
        shape = (B, self.num_heads, cache_capacity, self.head_size)
        cache = DecoderCache([], [], [], [])
        for layer in self._layers():
            ck, cv = layer.cross_att.project_kv(enc_feat, enc_feat)
            cache.cross_k.append(ck)
            cache.cross_v.append(cv)
            cache.self_k.append(torch.zeros(shape, dtype=self.dtype,
                                            device=enc_feat.device))
            cache.self_v.append(torch.zeros(shape, dtype=self.dtype,
                                            device=enc_feat.device))
        return cache

    def decode_step(self, tgt_emb: torch.Tensor, cache: DecoderCache,
                    src_mask: Optional[torch.Tensor]) -> torch.Tensor:
        """tgt_emb (B, 1, D) at position ``cache.position``; advances the
        position by one. Returns the decoder output (B, 1, D)."""
        if cache.position >= cache.self_k[0].shape[2]:
            raise ValueError("decoder KV cache is full")
        tgt = self.posenc(tgt_emb, offset=cache.position)
        for i, layer in enumerate(self._layers()):
            tgt = layer.decode_step(tgt, cache, i, src_mask)
        cache.position += 1
        if self.layernorm is not None:
            tgt = self.layernorm(tgt)
        return tgt
