"""Standalone autoregressive language model (counterpart of
``speechain_tpu/nn/lm.py``, :25-67).

Token embedding -> causal :class:`TransformerEncoder` -> token postnet.
:meth:`LanguageModelNet.forward` is the full-sequence pass (training, and
the windowed fusion of ASR beam search); its self-attention goes through
the flash-attention kernel with causality as a flag.
:meth:`LanguageModelNet.prime` and :meth:`LanguageModelNet.decode_step`
score one token a step over KV caches, for shallow fusion into beam
search. Module names are the JAX module's, so
``utils/weights.py::from_flax_variables`` bridges its variables.
"""

from __future__ import annotations

import dataclasses
from typing import Any, Dict, Optional, Tuple

import torch
from torch import nn

from speechain_tpu_torch.nn.postnets import TokenPostnet
from speechain_tpu_torch.nn.prenets import EmbedPrenet
from speechain_tpu_torch.nn.transformer import (EncoderCache,
                                                TransformerEncoder)
from speechain_tpu_torch.utils.masks import make_mask_from_len


@dataclasses.dataclass(frozen=True)
class LMConfig:
    vocab_size: int
    emb: Dict[str, Any] = dataclasses.field(default_factory=dict)
    encoder: Dict[str, Any] = dataclasses.field(default_factory=dict)
    dtype: torch.dtype = torch.float32
    param_dtype: Optional[torch.dtype] = None


class LanguageModelNet(nn.Module):
    """The LM network; ``param_dtype`` float32 keeps float32 master
    weights under a bf16 ``dtype`` (training), as ``ARASRConfig``."""

    def __init__(self, cfg: LMConfig):
        super().__init__()
        self.cfg = c = cfg
        enc = dict(c.encoder, uni_direction=True)
        self.embedding = EmbedPrenet(c.vocab_size, dtype=c.dtype, **c.emb)
        self.encoder = TransformerEncoder(dtype=c.dtype, **enc)
        self.postnet = TokenPostnet(enc.get("d_model", 512), c.vocab_size,
                                    dtype=c.dtype)
        if c.param_dtype is not None:
            self.to(c.param_dtype)

    def forward(self, text: torch.Tensor, text_len: torch.Tensor
                ) -> Tuple[torch.Tensor, torch.Tensor]:
        """text (B, T) int, text_len (B,) -> (logits (B, T, V), the
        encoder's mask: the (B, 1, T) length mask ANDed with the causal
        one)."""
        mask = make_mask_from_len(text_len, text.shape[1])
        enc, mask = self.encoder(self.embedding(text), mask)
        return self.postnet(enc), mask

    def prime(self, batch: int, cache_capacity: int) -> EncoderCache:
        """Zeroed KV caches of ``cache_capacity`` positions for ``batch``
        rows, on the device that holds the net."""
        return self.encoder.prime(batch, cache_capacity,
                                  self.postnet.linear.weight.device)

    def decode_step(self, token: torch.Tensor,
                    cache: EncoderCache) -> torch.Tensor:
        """token (B, 1) int -> logits (B, 1, V); advances ``cache``."""
        return self.postnet(self.encoder.decode_step(self.embedding(token),
                                                     cache))
