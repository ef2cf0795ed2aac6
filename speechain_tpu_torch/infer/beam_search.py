"""Batched beam search over a KV-cached decoder with CTC prefix fusion,
shallow LM fusion and internal-LM subtraction (counterpart of
``speechain_tpu/infer/beam_search.py``).

Same decoding semantics as the reference (reference
``infer_func/beam_search.py:106-550``):
- scores: log_softmax(logits / temperature); with a CTC scorer and
  ctc_weight > 0, the blank column set to NEG_INF and
  (1 - ctc_weight) * att + ctc_weight * ctc, the CTC prefix increments;
  then + lm.weight * log_softmax(lm_logits / lm.temperature) and
  - ilm.weight * log_softmax(ilm_logits), in that order (:310-373);
- top-2K candidate selection; an <eos> candidate is only eligible if its
  rank < K and, with eos_filtering, if its log-prob exceeds
  eos_threshold * the best other token of its source beam (the fused
  scores);
- finished score = sum_logprobs / (hyp_len + eps)^length_penalty;
- a sentence is done when its pool has K hyps and the best current raw
  score normalized by the current length cannot beat the worst pool entry;
- unfinished sentences at maxlen contribute their alive beams.

``jax.lax.while_loop`` becomes a Python loop that stops when every
sentence is done or the length cap is reached. ``jax.lax.top_k`` breaks
ties toward the lower index, and masked candidates (NEG_INF) tie exactly,
so selection is a stable descending sort (:func:`topk_stable`). The CTC
state follows the chosen beams (frozen sentences keep theirs and extend it
by their last token, as the reference does); so do the LM and ILM
caches. A windowed LM (``StepScorer.window_size > 0``, the reference's
``lm_window_size``, beam_search.py:321-339) keeps no cache: each step
re-scores the last W tokens of [sos] + prefix from position 0.
"""

from __future__ import annotations

import dataclasses
from typing import Any, Callable, Dict, Optional, Tuple

import torch

from speechain_tpu_torch.infer.ctc_scorer import CTCPrefixScorer

NEG_INF = -1e20
EPS = 1e-20


@dataclasses.dataclass
class StepScorer:
    """A KV-cached autoregressive scorer: ``step(cache, token (BK, 1)) ->
    (logits (BK, 1, V), cache)``, ``cache.reorder(beam_idx)`` after each
    step. With ``window_size > 0`` it is windowed instead: ``step(tokens
    (BK, W), lens (BK,)) -> logits (BK, W, V)`` and ``cache`` is None."""

    step: Callable
    cache: Any
    weight: float = 0.0
    temperature: float = 1.0
    window_size: int = 0


def topk_stable(x: torch.Tensor, k: int) -> Tuple[torch.Tensor, torch.Tensor]:
    """Top-k along the last axis with ties in index order, as
    ``jax.lax.top_k``."""
    vals, idx = torch.sort(x, dim=-1, descending=True, stable=True)
    return vals[..., :k], idx[..., :k]


def _len_norm(length: int, length_penalty: float, device) -> torch.Tensor:
    """(length + eps) ** length_penalty in float32, as the reference."""
    return (torch.tensor(float(length), dtype=torch.float32, device=device)
            + EPS) ** length_penalty


def beam_search(
    step: Callable[[Any, torch.Tensor], Tuple[torch.Tensor, Any]],
    cache: Any,
    enc_T: int,
    enc_len: torch.Tensor,
    batch_size: int,
    vocab_size: int,
    sos_eos: int,
    *,
    padding_idx: int = 0,
    beam_size: int = 4,
    min_f2t_ratio: float = 3.0,
    length_penalty: float = 1.0,
    temperature: float = 1.0,
    eos_filtering: bool = False,
    eos_threshold: float = 1.5,
    ctc_weight: float = 0.0,
    ctc_scorer: Optional[CTCPrefixScorer] = None,
    lm: Optional[StepScorer] = None,
    ilm: Optional[StepScorer] = None,
    max_len: Optional[int] = None,
    sent_per_beam: int = 1,
) -> Dict[str, torch.Tensor]:
    """``step(cache, token (BK, 1)) -> (logits (BK, 1, V), cache)``;
    ``cache.reorder(beam_idx (BK,))`` returns the cache with its rows
    gathered (``nn/transformer.py::DecoderCache``). ``lm`` fuses an
    external LM, ``ilm`` subtracts an internal LM, each where its weight
    is above 0."""
    use_ctc = ctc_scorer is not None and ctc_weight > 0.0
    use_lm = lm is not None and lm.weight > 0.0
    use_ilm = ilm is not None and ilm.weight > 0.0
    B, K, V = batch_size, beam_size, vocab_size
    BK = B * K
    dev = enc_len.device
    maxlen = max_len if max_len is not None else (
        int(enc_T / min_f2t_ratio) if min_f2t_ratio > 0
        else int(-min_f2t_ratio))
    maxlen = max(maxlen, 2)
    L = maxlen
    f32, i64 = dict(dtype=torch.float32, device=dev), dict(dtype=torch.long,
                                                           device=dev)

    rows = torch.arange(B, device=dev)[:, None]                  # (B, 1)
    identity_idx = (rows * K + torch.arange(K, device=dev)[None]).reshape(-1)
    alive_seq = torch.full((B, K, L), padding_idx, **i64)
    alive_score = torch.full((B, K), NEG_INF, **f32)
    alive_score[:, 0] = 0.0
    last_token = torch.full((B, K), sos_eos, **i64)
    fin_seq = torch.full((B, K, L), padding_idx, **i64)
    fin_score = torch.full((B, K), NEG_INF, **f32)
    fin_len = torch.zeros((B, K), **i64)
    done = torch.zeros(B, dtype=torch.bool, device=dev)
    rank = torch.arange(2 * K, device=dev)[None]
    ctc_state = ctc_scorer.init_state() if use_ctc else None
    lm_cache = lm.cache if use_lm else None
    ilm_cache = ilm.cache if use_ilm else None
    sos_col = torch.full((BK, 1), sos_eos, **i64)

    cur_len = 0
    while cur_len < maxlen - 1 and not bool(done.all()):
        tok_in = last_token.reshape(BK, 1)
        logits, cache = step(cache, tok_in)
        logp = torch.log_softmax(logits[:, -1].float() / temperature, -1)
        if use_ctc:
            logp[:, padding_idx] = NEG_INF
            ctc_inc = ctc_scorer.score(ctc_state)                 # (BK, V)
            logp = (1.0 - ctc_weight) * logp + ctc_weight * ctc_inc
        if use_lm:
            if lm.window_size > 0:
                # the last W tokens of [sos] + prefix, positions from 0;
                # a shorter prefix keeps its true length, and the causal
                # mask hides the slack behind it from the scored position
                W = min(lm.window_size, L + 1)
                plen = cur_len + 1
                start = max(0, plen - W)
                win = torch.cat([sos_col, alive_seq.reshape(BK, L)],
                                1)[:, start:start + W]
                wlen = min(plen, W)
                lm_logits = lm.step(win, torch.full((BK,), wlen, **i64))
                lm_logits = lm_logits[:, wlen - 1]
            else:
                lm_logits, lm_cache = lm.step(lm_cache, tok_in)
                lm_logits = lm_logits[:, -1]
            logp = logp + lm.weight * torch.log_softmax(
                lm_logits.float() / lm.temperature, -1)
        if use_ilm:
            ilm_logits, ilm_cache = ilm.step(ilm_cache, tok_in)
            logp = logp - ilm.weight * torch.log_softmax(
                ilm_logits[:, -1].float(), -1)

        cand = (alive_score.reshape(BK, 1) + logp).reshape(B, K * V)
        top_score, top_idx = topk_stable(cand, 2 * K)             # (B, 2K)
        top_beam = top_idx // V
        top_token = top_idx % V

        is_eos = top_token == sos_eos
        eos_ok = is_eos & (rank < K) & ~done[:, None]
        if eos_filtering:
            no_eos = logp.clone()
            no_eos[:, sos_eos] = NEG_INF
            ref_best = no_eos.amax(-1).reshape(B, K)
            eos_sc = logp[:, sos_eos].reshape(B, K)
            pass_filter = eos_sc > eos_threshold * ref_best
            eos_ok = eos_ok & torch.gather(pass_filter, 1, top_beam)

        # ---- finished pool update ----------------------------------------
        hyp_len = cur_len
        eos_norm = top_score / _len_norm(hyp_len, length_penalty, dev)
        eos_norm = torch.where(eos_ok, eos_norm,
                               torch.full((), NEG_INF, **f32))
        flat_beam = (rows * K + top_beam).reshape(-1)
        cand_seq = alive_seq.reshape(BK, L)[flat_beam].reshape(B, 2 * K, L)
        pool_scores = torch.cat([fin_score, eos_norm], 1)         # (B, 3K)
        pool_seqs = torch.cat([fin_seq, cand_seq], 1)
        pool_lens = torch.cat(
            [fin_len, torch.full((B, 2 * K), hyp_len, **i64)], 1)
        new_fin_score, sel = topk_stable(pool_scores, K)
        new_fin_seq = torch.gather(pool_seqs, 1,
                                   sel[..., None].expand(B, K, L))
        new_fin_len = torch.gather(pool_lens, 1, sel)
        keep = done[:, None]
        new_fin_score = torch.where(keep, fin_score, new_fin_score)
        new_fin_seq = torch.where(keep[..., None], fin_seq, new_fin_seq)
        new_fin_len = torch.where(keep, fin_len, new_fin_len)

        # ---- alive beams: first K non-eos candidates in rank order ------
        alive_cand = torch.where(is_eos, torch.full((), NEG_INF, **f32),
                                 top_score)
        a_score, a_sel = topk_stable(alive_cand, K)
        a_beam = torch.gather(top_beam, 1, a_sel)
        a_token = torch.gather(top_token, 1, a_sel)
        beam_idx = (rows * K + a_beam).reshape(-1)
        new_alive_seq = alive_seq.reshape(BK, L)[beam_idx].reshape(B, K, L)
        new_alive_seq[:, :, cur_len] = a_token
        freeze = done[:, None]
        new_alive_seq = torch.where(freeze[..., None], alive_seq,
                                    new_alive_seq)
        a_score = torch.where(freeze, alive_score, a_score)
        a_token = torch.where(freeze, last_token, a_token)
        beam_idx = torch.where(freeze, identity_idx.reshape(B, K),
                               beam_idx.reshape(B, K)).reshape(-1)
        cache = cache.reorder(beam_idx)
        if lm_cache is not None:
            lm_cache = lm_cache.reorder(beam_idx)
        if use_ilm:
            ilm_cache = ilm_cache.reorder(beam_idx)
        if use_ctc:
            ctc_state = ctc_scorer.update_state(ctc_state, ctc_inc, beam_idx,
                                                a_token.reshape(-1))

        # ---- done condition ---------------------------------------------
        pool_full = (new_fin_score > NEG_INF / 2).sum(1) >= K
        best_raw = top_score.amax(1)
        cur_norm = best_raw / _len_norm(cur_len, length_penalty, dev)
        done = done | (pool_full & (cur_norm < new_fin_score.amin(1)))

        cur_len += 1
        alive_seq, alive_score, last_token = new_alive_seq, a_score, a_token
        fin_seq, fin_score, fin_len = new_fin_seq, new_fin_score, new_fin_len

    # unfinished sentences: pool their alive beams
    alive_norm = alive_score / _len_norm(cur_len, length_penalty, dev)
    alive_norm = torch.where(done[:, None], torch.full((), NEG_INF, **f32),
                             alive_norm)
    pool_scores = torch.cat([fin_score, alive_norm], 1)
    pool_seqs = torch.cat([fin_seq, alive_seq], 1)
    pool_lens = torch.cat([fin_len, torch.full((B, K), cur_len, **i64)], 1)
    N = max(1, min(sent_per_beam, pool_scores.shape[1]))
    best_score, best = topk_stable(pool_scores, N)
    hypo = torch.gather(pool_seqs, 1, best[..., None].expand(B, N, L))
    hypo_len = torch.gather(pool_lens, 1, best)
    pos = torch.arange(L, device=dev)[None, None]
    hypo = torch.where(pos < hypo_len[..., None], hypo,
                       torch.full((), padding_idx, **i64))

    out = dict(
        hypo_text=hypo[:, 0],
        hypo_text_len=hypo_len[:, 0],
        hypo_text_confid=best_score[:, 0],
        feat_token_len_ratio=enc_len.float()
        / (hypo_len[:, 0].float() + 1e-10),
        steps=cur_len,
    )
    if N > 1:
        out.update(nbest_text=hypo, nbest_text_len=hypo_len,
                   nbest_confid=best_score)
    return out
