"""ASR inference entry points (counterpart of ``speechain_tpu/infer/asr.py``):
encoder pass + KV-cached beam search over an :class:`ARASRNet`, with CTC
prefix fusion (``ctc_weight``, where the net has a CTC head; its
recursions run in the kernels of ``ops/cuda_ctc_prefix.py`` on the card),
shallow fusion of an external :class:`~speechain_tpu_torch.nn.lm.
LanguageModelNet` (``lm_net``, ``lm_weight``: KV-cached, or windowed with
``lm_window_size``), internal-LM subtraction (``ilm_sub_weight``: the
ASR decoder over a zeroed one-frame encoder output), greedy decoding
(beam 1) and the teacher-forced scoring pass whose confidences the chain
recipes use to filter pseudo-labels.
"""

from __future__ import annotations

from typing import Dict, Optional

import torch

from speechain_tpu_torch.infer.beam_search import (NEG_INF, StepScorer,
                                                   beam_search)
from speechain_tpu_torch.infer.ctc_scorer import CTCPrefixScorer
from speechain_tpu_torch.utils.device import (resolve_device,
                                              set_fp32_matmul_exact)


def asr_beam_search(
    net,
    feat: torch.Tensor,
    feat_len: torch.Tensor,
    *,
    beam_size: int = 4,
    min_f2t_ratio: float = 3.0,
    length_penalty: float = 1.0,
    temperature: float = 1.0,
    eos_filtering: bool = False,
    eos_threshold: float = 1.5,
    ctc_weight: float = 0.0,
    ctc_temperature: float = 1.0,
    lm_net=None,
    lm_weight: float = 0.0,
    lm_temperature: float = 1.0,
    lm_window_size: Optional[int] = None,
    ilm_sub_weight: float = 0.0,
    sent_per_beam: int = 1,
    sos_eos: Optional[int] = None,
    padding_idx: int = 0,
    max_len: Optional[int] = None,
    group_ids: Optional[torch.Tensor] = None,
) -> Dict[str, torch.Tensor]:
    """Full inference on the device that holds ``net`` (and ``lm_net``):
    encoder pass, then batched beam search. ``group_ids`` selects
    per-group feature-norm statistics (unseen groups use the all-group
    average). CTC prefix fusion runs where ``ctc_weight > 0`` and the net
    has a CTC head (``cfg.ctc_weight > 0``); LM fusion where ``lm_net`` is
    given and ``lm_weight > 0`` (either alone is ignored, as in the
    reference); internal-LM subtraction where ``ilm_sub_weight > 0``."""
    V = net.cfg.vocab_size
    sos_eos = V - 1 if sos_eos is None else sos_eos
    B, K = feat.shape[0], beam_size

    with torch.inference_mode():
        enc_feat, enc_len, enc_mask = net.encode(feat, feat_len, group_ids)
        T_enc = enc_feat.shape[1]
        enc_rep = enc_feat.repeat_interleave(K, dim=0)
        mask_rep = enc_mask.repeat_interleave(K, dim=0)
        maxlen = max_len if max_len is not None else (
            int(T_enc / min_f2t_ratio) if min_f2t_ratio > 0
            else int(-min_f2t_ratio))
        maxlen = max(maxlen, 2)
        cache = net.prime(enc_rep, maxlen)

        def step(cache, token):
            return net.decode_step(token, cache, mask_rep), cache

        lm = None
        if lm_net is not None and lm_weight > 0.0:
            if lm_window_size:
                lm = StepScorer(lambda tokens, lens: lm_net(tokens, lens)[0],
                                None, lm_weight, lm_temperature,
                                int(lm_window_size))
            else:
                lm = StepScorer(
                    lambda cache, token: (lm_net.decode_step(token, cache),
                                          cache),
                    lm_net.prime(B * K, maxlen), lm_weight, lm_temperature)

        ilm = None
        if ilm_sub_weight > 0.0:
            # the decoder over a zeroed one-frame encoder output
            ones = torch.ones((B * K, 1, 1), dtype=torch.bool,
                              device=enc_rep.device)
            ilm = StepScorer(
                lambda cache, token: (net.decode_step(token, cache, ones),
                                      cache),
                net.prime(torch.zeros_like(enc_rep[:, :1]), maxlen),
                ilm_sub_weight)

        ctc_scorer = None
        if ctc_weight > 0.0 and net.cfg.ctc_weight > 0.0:
            ctc_logits = net.ctc_logits(enc_feat)
            ctc_logits[:, :, sos_eos] = NEG_INF      # in the logits' dtype
            ctc_logp = torch.log_softmax(
                ctc_logits.float() / ctc_temperature, -1)
            ctc_scorer = CTCPrefixScorer(ctc_logp, enc_len, K,
                                         blank_id=padding_idx, eos_id=sos_eos)

        return beam_search(
            step, cache, T_enc, enc_len, B, V, sos_eos,
            padding_idx=padding_idx, beam_size=K,
            min_f2t_ratio=min_f2t_ratio, length_penalty=length_penalty,
            temperature=temperature, eos_filtering=eos_filtering,
            eos_threshold=eos_threshold, ctc_weight=ctc_weight,
            ctc_scorer=ctc_scorer, lm=lm, ilm=ilm, max_len=max_len,
            sent_per_beam=sent_per_beam)


def asr_greedy_decode(net, feat: torch.Tensor, feat_len: torch.Tensor, *,
                      device=None, group_ids: Optional[torch.Tensor] = None,
                      lm_net=None, **kw) -> Dict[str, torch.Tensor]:
    """Greedy decoding: :func:`asr_beam_search` at beam size 1, with
    ``net``, ``lm_net`` and the inputs on ``device`` as
    :func:`make_asr_decoder` puts them (default: the CUDA card; ``"cpu"``
    runs the plain PyTorch versions of the kernels)."""
    put = _on_device(net, device, lm_net)
    return asr_beam_search(net, put(feat), put(feat_len),
                           group_ids=put(group_ids), beam_size=1,
                           lm_net=lm_net, **kw)


def asr_teacher_forcing(net, feat: torch.Tensor, feat_len: torch.Tensor,
                        text: torch.Tensor, text_len: torch.Tensor, *,
                        temperature: float = 1.0) -> Dict[str, torch.Tensor]:
    """Teacher-forced scoring pass (reference ``model/ar_asr.py:874-921``):
    the decoder runs on the ground-truth text (<sos/eos> at both ends),
    and each utterance gets its confidence, the mean log-prob of its
    target tokens, and its feature-to-token length ratio."""
    with torch.inference_mode():
        enc_feat, enc_len, enc_mask = net.encode(feat, feat_len)
        logits = net.decode(enc_feat, enc_mask, text, text_len)
        logp = torch.log_softmax(logits.float() / temperature, -1)
        tgt = text[:, 1:].long()
        lp = torch.gather(logp[:, :tgt.shape[1]], -1, tgt[..., None])[..., 0]
        pos = torch.arange(tgt.shape[1], device=tgt.device)[None]
        mask = pos < (text_len - 1)[:, None]
        lp = torch.where(mask, lp, 0.0)
        n = torch.clamp((text_len - 1).float(), min=1.0)
        hypo = torch.where(mask, logits.argmax(-1), 0)
        return dict(
            hypo_text=hypo,
            hypo_text_len=torch.clamp(text_len - 2, min=0),
            hypo_text_confid=lp.sum(-1) / n,
            feat_token_len_ratio=enc_len.float()
            / torch.clamp(text_len - 2, min=1).float())


def _on_device(net, device, lm_net=None):
    """``net`` (and ``lm_net``) moved to ``device`` (default: the CUDA
    card; ``"cpu"`` runs the plain PyTorch versions of the kernels) in
    evaluation mode, and a function that moves a tensor (or None)
    there."""
    dev = resolve_device(device)
    if dev.type == "cuda":
        set_fp32_matmul_exact()
    for n in (net, lm_net):
        if n is not None:
            n.to(dev).eval()

    def put(x):
        return None if x is None else torch.as_tensor(x).to(dev)
    return put


def make_asr_decoder(net, *, device=None, lm_net=None, **decode_kwargs):
    """Move ``net`` and ``lm_net`` to ``device`` (default: the CUDA card;
    ``"cpu"`` runs the plain PyTorch versions of the kernels) and return
    ``fn(feat, feat_len, group_ids=None) -> results``; inputs are moved to
    the same device."""
    put = _on_device(net, device, lm_net)

    def decode(feat, feat_len, group_ids=None):
        return asr_beam_search(net, put(feat), put(feat_len),
                               group_ids=put(group_ids), lm_net=lm_net,
                               **decode_kwargs)

    return decode


def make_asr_teacher_scorer(net, *, device=None, **kwargs):
    """As :func:`make_asr_decoder`, for :func:`asr_teacher_forcing`:
    ``fn(feat, feat_len, text, text_len) -> results``."""
    put = _on_device(net, device)

    def score(feat, feat_len, text, text_len):
        return asr_teacher_forcing(net, put(feat), put(feat_len), put(text),
                                   put(text_len), **kwargs)

    return score
