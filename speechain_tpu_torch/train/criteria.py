"""Training criteria on the device (counterpart of
``speechain_tpu/train/criteria.py``): the ASR step's cross entropy,
accuracy and CTC loss, the LM step's :func:`perplexity`, and the TTS
steps' feature regression
(:func:`least_error`), positive-weighted BCE (:func:`bce_logits`),
F-beta (:func:`fbeta_score`), the diagonal attention guidance
(:func:`attention_guidance`) and the stop-flag accuracy
(:func:`stop_accuracy`), mask-based, with no host synchronisation.

Parity notes:
- label smoothing spreads eps / V over the whole vocabulary, not
  eps / (V - 1) (reference criterion/cross_entropy.py, :37-72);
- sentence sums are averaged over rows with ``text_len > 0``: zero-length
  rows are batch padding;
- CTC (:101-138) uses ``torch.nn.functional.ctc_loss`` per row (no Pallas
  kernel computes it) with the reference's ``zero_infinity`` rule applied
  here: a row that cannot be aligned (fewer frames than labels plus
  forced blanks between repeats) or whose loss is not finite gives 0, and
  stays in the denominator.
"""

from __future__ import annotations

from typing import Optional

import torch
import torch.nn.functional as F


def _len_mask(lengths: torch.Tensor, max_len: int) -> torch.Tensor:
    pos = torch.arange(max_len, device=lengths.device)
    return pos[None, :] < lengths.to(torch.int64)[:, None]


def _maybe_shift(logits: torch.Tensor, text: torch.Tensor,
                 text_len: torch.Tensor):
    """If logits cover one step fewer than text, drop text's leading
    <sos> and decrement the lengths (cross_entropy.py:110-122)."""
    if logits.shape[1] == text.shape[1] - 1:
        return text[:, 1:], text_len - 1
    if logits.shape[1] != text.shape[1]:
        raise ValueError(f"logits length {logits.shape[1]} vs text length "
                         f"{text.shape[1]}")
    return text, text_len


def cross_entropy(logits: torch.Tensor, text: torch.Tensor,
                  text_len: torch.Tensor, *,
                  label_smoothing: float = 0.0) -> torch.Tensor:
    """Per-sentence summed CE with label smoothing, averaged over
    non-empty sentences."""
    text, text_len = _maybe_shift(logits, text, text_len)
    B, L, V = logits.shape
    log_prob = torch.log_softmax(logits.float(), dim=-1)
    lp_target = log_prob.gather(-1, text.long()[..., None])[..., 0]
    if label_smoothing > 0.0:
        tok = (lp_target * (1.0 - label_smoothing)
               + log_prob.sum(-1) * (label_smoothing / V))
    else:
        tok = lp_target
    tok = torch.where(_len_mask(text_len, L), tok, torch.zeros_like(tok))
    sent = tok.sum(-1)
    valid = (text_len > 0).to(torch.float32)
    return -(sent * valid).sum() / torch.clamp(valid.sum(), min=1.0)


def accuracy(logits: torch.Tensor, text: torch.Tensor,
             text_len: torch.Tensor) -> torch.Tensor:
    """Token prediction accuracy over the valid positions."""
    text, text_len = _maybe_shift(logits, text, text_len)
    pred = logits.argmax(-1)
    mask = _len_mask(text_len, text.shape[1])
    correct = ((pred == text.long()) & mask).sum()
    return correct / torch.clamp(torch.clamp(text_len, min=0).sum(), min=1)


def perplexity(logits: torch.Tensor, text: torch.Tensor,
               text_len: torch.Tensor) -> torch.Tensor:
    """Mean per-sentence perplexity (perplexity.py:7-34): logits predict
    text[:, 1:], normalized by (text_len - 1); rows with text_len 0 are
    left out."""
    log_prob = torch.log_softmax(logits.float(), dim=-1)
    tgt = text[:, 1:].long()
    lp = log_prob[:, :tgt.shape[1]].gather(-1, tgt[..., None])[..., 0]
    lp = torch.where(_len_mask(text_len - 1, tgt.shape[1]), lp,
                     torch.zeros_like(lp))
    n = torch.clamp((text_len - 1).to(torch.float32), min=1.0)
    valid = (text_len > 0).to(torch.float32)
    ppl = torch.exp(-lp.sum(-1) / n)
    return (ppl * valid).sum() / torch.clamp(valid.sum(), min=1.0)


def ctc_loss(ctc_logits: torch.Tensor, logit_len: torch.Tensor,
             text: torch.Tensor, text_len: torch.Tensor, *,
             blank_id: int = 0) -> torch.Tensor:
    """Mean over non-empty rows of the per-row CTC negative
    log-likelihood; ``text`` holds no sos/eos."""
    B, T, V = ctc_logits.shape
    log_probs = torch.log_softmax(ctc_logits.float(), -1).transpose(0, 1)
    per_seq = F.ctc_loss(log_probs, text.long(),
                         torch.clamp(logit_len, min=0).long(),
                         torch.clamp(text_len, min=0).long(),
                         blank=blank_id, reduction="none",
                         zero_infinity=True)
    # adjacent equal labels force a blank between them: a feasible row
    # needs a frame per label plus one per forced blank
    if text.shape[1] >= 2:
        pair_ok = _len_mask(torch.clamp(text_len - 1, min=0),
                            text.shape[1] - 1)
        dups = ((text[:, 1:] == text[:, :-1]) & pair_ok).sum(-1)
    else:
        dups = torch.zeros_like(text_len)
    valid = ((text_len > 0) & (logit_len >= text_len + dups)
             & torch.isfinite(per_seq))
    per_seq = torch.where(valid, per_seq, torch.zeros_like(per_seq))
    denom = (text_len > 0).to(torch.float32).sum()
    return per_seq.sum() / torch.clamp(denom, min=1.0)


def least_error(pred: torch.Tensor, tgt: torch.Tensor,
                tgt_len: torch.Tensor, *, loss_type: str = "L2",
                is_normalized: bool = True) -> torch.Tensor:
    """L1 / L2 / L1+L2 regression loss (reference least_error.py:17-130,
    criteria.py:141): the per-position mean over the last axis ((B, T)
    inputs are one feature wide), summed over the valid positions and
    divided by their count (``is_normalized``) or by the batch."""
    if pred.ndim == 2:
        pred = pred[..., None]
    if tgt.ndim == 2:
        tgt = tgt[..., None]
    diff = pred.float() - tgt.float()
    if loss_type == "L1":
        loss = diff.abs()
    elif loss_type == "L2":
        loss = diff * diff
    elif loss_type == "L1+L2":
        loss = diff.abs() + diff * diff
    else:
        raise ValueError(loss_type)
    loss = loss.mean(-1)                                        # (B, T)
    mask = _len_mask(tgt_len, loss.shape[1])
    loss = torch.where(mask, loss, torch.zeros_like(loss))
    if is_normalized:
        return loss.sum() / torch.clamp(mask.sum(), min=1)
    return loss.sum(-1).mean()


def bce_logits(pred: torch.Tensor, tgt: torch.Tensor,
               tgt_len: torch.Tensor, *, pos_weight: float = 5.0,
               is_normalized: bool = True) -> torch.Tensor:
    """torch ``BCEWithLogitsLoss`` with ``pos_weight`` over the valid
    positions (reference bce_logits.py:17-90, criteria.py:171)."""
    p = pred.float()
    tgt = tgt.float()
    loss = -(pos_weight * tgt * F.logsigmoid(p)
             + (1.0 - tgt) * F.logsigmoid(-p))
    mask = _len_mask(tgt_len, loss.shape[1])
    loss = torch.where(mask, loss, torch.zeros_like(loss))
    if is_normalized:
        return loss.sum() / torch.clamp(mask.sum(), min=1)
    return loss.sum(-1).mean()


def fbeta_score(pred: torch.Tensor, tgt: torch.Tensor,
                tgt_len: torch.Tensor, *, beta: float = 1.0) -> torch.Tensor:
    """F-beta of binary predictions over the valid positions (reference
    fbeta_score.py:13-52, criteria.py:188)."""
    mask = _len_mask(tgt_len, tgt.shape[1])
    pred_pos = (pred == 1) & mask
    tgt_pos = (tgt == 1) & mask
    tp = (pred_pos & tgt_pos).sum().float()
    fp = (pred_pos & ~tgt_pos).sum().float()
    fn = (~pred_pos & tgt_pos).sum().float()
    precision = tp / (tp + fp + 1e-10)
    recall = tp / (tp + fn + 1e-10)
    b2 = beta ** 2
    return (1 + b2) * precision * recall / (b2 * precision + recall + 1e-10)


def attention_guidance(att: torch.Tensor, x_len: torch.Tensor,
                       y_len: Optional[torch.Tensor] = None, *,
                       sigma: float = 0.2) -> torch.Tensor:
    """Diagonal-prior attention guidance (reference att_guid.py:6-76,
    criteria.py:204): att (B, H, X, Y); weight 1 - exp(-(x / X_i -
    y / Y_i)^2 / (2 sigma^2)) inside each row's valid (X_i, Y_i)
    rectangle, lengths clipped to (X, Y); the weighted sum over the valid
    cells divided by their count times H."""
    if y_len is None:
        y_len = x_len
    B, H, X, Y = att.shape
    coeff = -1.0 / (2.0 * sigma ** 2)
    gx = torch.arange(X, device=att.device, dtype=torch.float32)[None, :,
                                                                  None]
    gy = torch.arange(Y, device=att.device, dtype=torch.float32)[None,
                                                                  None, :]
    xl = torch.clamp(x_len, max=X).float()[:, None, None]
    yl = torch.clamp(y_len, max=Y).float()[:, None, None]
    weight = 1.0 - torch.exp(coeff * (gx / xl - gy / yl) ** 2)   # (B, X, Y)
    valid = (gx < xl) & (gy < yl)
    weighted = att.float() * weight[:, None]
    weighted = torch.where(valid[:, None], weighted,
                           torch.zeros_like(weighted))
    denom = torch.clamp(valid.sum() * H, min=1)
    return weighted.sum() / denom


def stop_accuracy(stop_pred: torch.Tensor, stop_tgt: torch.Tensor,
                  tgt_len: torch.Tensor) -> torch.Tensor:
    """Accuracy of the binary stop flags sigmoid(stop_pred) > 0.5 over the
    valid positions (reference ar_tts.py:528-534, criteria.py:228)."""
    mask = _len_mask(tgt_len, stop_tgt.shape[1])
    pred = torch.sigmoid(stop_pred.float()) > 0.5
    correct = (mask & (pred == (stop_tgt > 0.5))).sum()
    return correct / torch.clamp(mask.sum(), min=1)
