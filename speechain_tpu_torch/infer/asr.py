"""ASR inference entry points (counterpart of ``speechain_tpu/infer/asr.py``):
encoder pass + KV-cached beam search over an :class:`ARASRNet`.

Attention-only decoding is ported: CTC prefix fusion (``ctc_weight``),
external-LM shallow fusion and internal-LM subtraction raise
``NotImplementedError`` until their slice.
"""

from __future__ import annotations

from typing import Dict, Optional

import torch

from speechain_tpu_torch.infer.beam_search import beam_search
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
    """Full inference on the device that holds ``net``: encoder pass, then
    batched beam search. ``group_ids`` selects per-group feature-norm
    statistics (unseen groups use the all-group average)."""
    if ctc_weight > 0.0:
        raise NotImplementedError("CTC prefix fusion is not ported yet")
    if lm_net is not None or lm_weight > 0.0:
        raise NotImplementedError("external-LM fusion is not ported yet")
    if ilm_sub_weight > 0.0:
        raise NotImplementedError("internal-LM subtraction is not ported yet")
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

        return beam_search(
            step, cache, T_enc, enc_len, B, V, sos_eos,
            padding_idx=padding_idx, beam_size=K,
            min_f2t_ratio=min_f2t_ratio, length_penalty=length_penalty,
            temperature=temperature, eos_filtering=eos_filtering,
            eos_threshold=eos_threshold, max_len=max_len,
            sent_per_beam=sent_per_beam)


def make_asr_decoder(net, *, device=None, **decode_kwargs):
    """Move ``net`` to ``device`` (default: the CUDA card; ``"cpu"`` runs
    the plain PyTorch versions of the kernels) and return
    ``fn(feat, feat_len, group_ids=None) -> results``; inputs are moved to
    the same device."""
    dev = resolve_device(device)
    if dev.type == "cuda":
        set_fp32_matmul_exact()
    net.to(dev).eval()

    def decode(feat, feat_len, group_ids=None):
        feat = torch.as_tensor(feat).to(dev)
        feat_len = torch.as_tensor(feat_len).to(dev)
        if group_ids is not None:
            group_ids = torch.as_tensor(group_ids).to(dev)
        return asr_beam_search(net, feat, feat_len, group_ids=group_ids,
                               **decode_kwargs)

    return decode
