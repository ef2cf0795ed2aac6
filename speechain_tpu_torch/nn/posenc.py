"""Positional encodings (counterpart of ``speechain_tpu/nn/posenc.py``).

Parity notes (reference pos_enc.py:115-190):
- 'mix' interleaves sin/cos; 'sep' puts all sin in the first half and cos
  (with an extended div_term) in the second half.
- optional LayerNorm on the embedded feature (flax ``nn.LayerNorm``, whose
  output takes float32 from its parameters), optional sqrt(d_model) scale,
  optional trainable scalar alpha on the PE; in training, dropout of the
  sum (``FlatDropout``).
Tables are float64 numpy computed once per module and cast to float32.
"""

from __future__ import annotations

import math

import numpy as np
import torch
from torch import nn

from speechain_tpu_torch.nn.norms import FlatDropout, LayerNorm


def sinusoid_table(max_len: int, d_model: int, posenc_type: str = "mix") -> np.ndarray:
    """(max_len, d_model) float32 sinusoid table (pos_enc.py:115-143)."""
    position = np.arange(max_len, dtype=np.float64)[:, None]
    div_term = np.exp(
        np.arange(0, d_model, 2, dtype=np.float64) * (math.log(10000.0) / d_model)
    )
    pe = np.zeros((max_len, d_model), dtype=np.float64)
    if posenc_type == "mix":
        pe[:, 0::2] = np.sin(position / div_term)
        pe[:, 1::2] = np.cos(position / div_term)
    elif posenc_type == "sep":
        div_term_ext = np.exp(
            np.arange(d_model, d_model * 2, 2, dtype=np.float64)
            * (math.log(10000.0) / d_model)
        )
        half = d_model // 2
        pe[:, :half] = np.sin(position / div_term)
        pe[:, half:] = np.cos(position / div_term_ext)
    else:
        raise ValueError(f"unknown posenc_type {posenc_type!r}")
    return pe.astype(np.float32)


def rel_sinusoid_table(max_len: int, d_model: int) -> np.ndarray:
    """(2*max_len-1, d_model) float32 table whose rows are relative
    positions +(max_len-1) .. -(max_len-1) (conformer/pos_enc.py:8)."""
    pos = np.arange(max_len - 1, -max_len, -1, dtype=np.float64)[:, None]
    div_term = np.exp(np.arange(0, d_model, 2, dtype=np.float64)
                      * -(math.log(10000.0) / d_model))
    table = np.zeros((2 * max_len - 1, d_model), dtype=np.float64)
    table[:, 0::2] = np.sin(pos * div_term)
    table[:, 1::2] = np.cos(pos * div_term)
    return table.astype(np.float32)


class PositionalEncoding(nn.Module):
    """Add a sinusoidal positional encoding to an embedded sequence.

    ``offset``: an int, a 0-d tensor (single-step decode at that position)
    or a (B,) tensor of per-row positions."""

    def __init__(self, d_model: int, posenc_type: str = "mix",
                 emb_layernorm: bool = False, emb_scale: bool = True,
                 posenc_scale: bool = False, init_alpha: float = 1.0,
                 dropout: float = 0.0, max_len: int = 5000):
        super().__init__()
        self.d_model = d_model
        self.emb_scale = emb_scale
        self.register_buffer("table", torch.from_numpy(
            sinusoid_table(max_len, d_model, posenc_type)), persistent=False)
        # flax's nn.LayerNorm in the reference (posenc.py:80), which never
        # takes the fused LayerNorm route
        self.emb_layernorm = (LayerNorm(d_model, fused=False)
                              if emb_layernorm else None)
        self.alpha = (nn.Parameter(torch.tensor(float(init_alpha)))
                      if posenc_scale else None)
        self.drop = FlatDropout(dropout)

    def forward(self, emb: torch.Tensor, offset=0) -> torch.Tensor:
        if self.emb_layernorm is not None:
            emb = self.emb_layernorm(emb.float())
        if self.emb_scale:
            emb = emb * math.sqrt(self.d_model)
        seq_len = emb.shape[1]
        steps = torch.arange(seq_len, device=emb.device)
        if isinstance(offset, int):
            pe = self.table[offset:offset + seq_len][None]
        elif offset.ndim == 1:
            pe = self.table[offset.long()[:, None] + steps[None, :]]
        else:
            pe = self.table[offset.long() + steps][None]
        if self.alpha is not None:
            pe = pe * self.alpha
        out = emb + pe.to(emb.dtype)
        return self.drop(out) if self.training else out


class RelPositionalEncoding(nn.Module):
    """Transformer-XL bidirectional relative PE (conformer/pos_enc.py:8).

    Returns (x * sqrt(d_model), pos_emb (1, 2L-1, d_model)) with pos_emb
    rows covering relative positions [L-1 .. -(L-1)]; in training both
    pass through dropout (``FlatDropout``, one stream each, x first), as
    the JAX module drops both (``nn/posenc.py:146-147``)."""

    def __init__(self, d_model: int, dropout: float = 0.0,
                 max_len: int = 5000):
        super().__init__()
        self.d_model = d_model
        self.max_len = max_len
        self.register_buffer("table", torch.from_numpy(
            rel_sinusoid_table(max_len, d_model)), persistent=False)
        self.drop = FlatDropout(dropout)

    def forward(self, x: torch.Tensor):
        x = x * math.sqrt(self.d_model)
        L = x.shape[1]
        if L > self.max_len:
            raise ValueError(f"sequence of {L} exceeds posenc max_len="
                             f"{self.max_len}")
        center = self.max_len - 1
        pos_emb = self.table[None, center - (L - 1): center + L]
        return self.drop(x), self.drop(pos_emb.to(x.dtype))
