"""Autoregressive transformer language model, task level (counterpart of
``speechain_tpu/models/lm.py``): the training loss over next-token
prediction. The network is :class:`speechain_tpu_torch.nn.lm.
LanguageModelNet`."""

from __future__ import annotations

from typing import Dict, Tuple

import torch

from speechain_tpu_torch.nn.lm import LanguageModelNet, LMConfig  # noqa: F401
from speechain_tpu_torch.train import criteria


def lm_loss(logits: torch.Tensor, text: torch.Tensor,
            text_len: torch.Tensor, *, label_smoothing: float = 0.0
            ) -> Tuple[torch.Tensor, Dict[str, torch.Tensor]]:
    """CE (with label smoothing) of logits[:, :-1] against text[:, 1:]:
    the caller feeds the whole <sos> ... <eos> sequence (reference
    lm.py:22-38). Returns (loss, metrics) as device tensors."""
    shifted = logits[:, :-1]
    ce = criteria.cross_entropy(shifted, text, text_len,
                                label_smoothing=label_smoothing)
    metrics = dict(ce_loss=ce,
                   accuracy=criteria.accuracy(shifted, text, text_len),
                   text_ppl=criteria.perplexity(shifted, text, text_len),
                   loss=ce)
    return ce, metrics
