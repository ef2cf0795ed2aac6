"""The TTS text encoder (counterpart of ``speechain_tpu/models/ar_tts.py``
``TTSEncoder`` :74, encoder/tts.py:20-87): token embedding -> optional
Conv1d prenet -> transformer encoder. FastSpeech2 uses it; the
autoregressive Transformer-TTS model is not ported yet."""

from __future__ import annotations

from typing import Any, Dict, Optional

import torch
from torch import nn

from speechain_tpu_torch.nn.prenets import Conv1dPrenet, EmbedPrenet
from speechain_tpu_torch.nn.transformer import TransformerEncoder
from speechain_tpu_torch.utils.masks import make_mask_from_len


class TTSEncoder(nn.Module):
    """``forward(text, text_len)`` -> (encoding (B, L, D), text_len, mask
    (B, 1, L))."""

    def __init__(self, vocab_size: int, emb: Dict[str, Any],
                 prenet: Optional[Dict[str, Any]], encoder: Dict[str, Any],
                 dtype: torch.dtype = torch.float32):
        super().__init__()
        self.embedding = EmbedPrenet(vocab_size, dtype=dtype, **emb)
        width = self.embedding.embedding_dim
        self.prenet = (None if prenet is None
                       else Conv1dPrenet(width, dtype=dtype, **prenet))
        self.encoder = TransformerEncoder(dtype=dtype, **encoder)

    def forward(self, text: torch.Tensor, text_len: torch.Tensor):
        x = self.embedding(text)
        if self.prenet is not None:
            x, text_len = self.prenet(x, text_len)
        mask = make_mask_from_len(text_len, x.shape[1])
        out, mask = self.encoder(x, mask)
        return out, text_len, mask
