"""Token postnet (counterpart of ``speechain_tpu/nn/postnets.py``):
linear projection to vocabulary logits (postnet/token.py:12-48)."""

from __future__ import annotations

import torch
from torch import nn

from speechain_tpu_torch.nn.dense import Dense


class TokenPostnet(nn.Module):
    def __init__(self, d_model: int, vocab_size: int,
                 dtype: torch.dtype = torch.float32):
        super().__init__()
        self.linear = Dense(d_model, vocab_size, dtype=dtype)

    def forward(self, feat: torch.Tensor) -> torch.Tensor:
        return self.linear(feat)
