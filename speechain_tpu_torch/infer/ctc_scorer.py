"""CTC prefix scorer (Watanabe's Algorithm 2), batched over beam rows
(counterpart of ``speechain_tpu/infer/ctc_scorer.py``; reference
``infer_func/ctc_decoding.py:6-196``).

The state of each decode step is the lattice r (T, 2, BK) of the current
prefixes (non-blank and blank endings), their scores psi (BK,) and last
tokens (BK,). :meth:`CTCPrefixScorer.score` returns psi(g + c) - psi(g)
for every token c, the incremental CTC log-prob that the beam search
fuses; :meth:`CTCPrefixScorer.update_state` advances to the chosen
candidates. Both run their recursion over frames in one kernel each on
the card (``ops/cuda_ctc_prefix.py``), where the reference runs a
``lax.scan``; a CPU tensor takes the kernels' plain versions.

``prefix_len`` is a Python int, one value for all rows, as the reference's
scalar: the beam search counts its steps on the host, so reading it needs
no device sync.
"""

from __future__ import annotations

from typing import NamedTuple, Optional

import torch

from speechain_tpu_torch.ops.cuda_ctc_prefix import (NEG_INF,
                                                     ctc_prefix_score,
                                                     ctc_prefix_update)


class CTCScorerState(NamedTuple):
    r: torch.Tensor            # (T, 2, BK) lattice of the current prefixes
    psi: torch.Tensor          # (BK,) log P_ctc(prefix)
    last_token: torch.Tensor   # (BK,) int64 last token, -1 when empty
    prefix_len: int            # tokens in every prefix (after <sos>)


class CTCPrefixScorer:
    """Batched prefix scorer over (batch x beam) rows.

    x_logp: (B, T, V) log-softmax CTC outputs, float32; row i of the BK
    rows reads utterance i // K (no (BK, T, V) copy)."""

    def __init__(self, x_logp: torch.Tensor, enc_len: torch.Tensor,
                 beam_size: int, blank_id: int = 0,
                 eos_id: Optional[int] = None):
        B, T, V = x_logp.shape
        self.B, self.T, self.V, self.K = B, T, V, beam_size
        self.blank_id = blank_id
        self.eos_id = V - 1 if eos_id is None else eos_id
        dev = x_logp.device
        # frames past enc_len: every token NEG_INF, blank 0
        valid = (torch.arange(T, device=dev)[None, :, None]
                 < enc_len.to(dev)[:, None, None])
        x = torch.where(valid, x_logp, NEG_INF)
        x[..., blank_id] = torch.where(valid[..., 0],
                                       x_logp[..., blank_id], 0.0)
        self.x = x.float().contiguous()                       # (B, T, V)
        self.x_blank = self.x[..., blank_id].contiguous()     # (B, T)
        self.enc_len = enc_len.to(device=dev, dtype=torch.long).contiguous()
        self.row = torch.arange(B, device=dev).repeat_interleave(beam_size)

    def init_state(self) -> CTCScorerState:
        """The empty prefix: r_b[t] the cumulative blank log-prob, r_nb
        NEG_INF."""
        BK = self.B * self.K
        dev = self.x.device
        rb = torch.cumsum(self.x_blank, 1)[self.row].T        # (T, BK)
        r = torch.stack([torch.full_like(rb, NEG_INF), rb], 1).contiguous()
        return CTCScorerState(
            r=r, psi=torch.zeros(BK, dtype=torch.float32, device=dev),
            last_token=torch.full((BK,), -1, dtype=torch.long, device=dev),
            prefix_len=0)

    def score(self, state: CTCScorerState) -> torch.Tensor:
        """(BK, V) incremental scores psi(g + c) - psi(g); the eos column
        holds the prefix's total at the last valid frame, blank NEG_INF."""
        return ctc_prefix_score(self.x, self.x_blank, self.enc_len, state.r,
                                state.psi, state.last_token,
                                state.prefix_len, self.K, self.blank_id,
                                self.eos_id)

    def update_state(self, state: CTCScorerState, psi_scores: torch.Tensor,
                     beam_idx: torch.Tensor,
                     token_idx: torch.Tensor) -> CTCScorerState:
        """Advance to the chosen candidates: reindex by ``beam_idx`` (BK,),
        extend each prefix by ``token_idx`` (BK,) and rebuild the lattice
        of the new prefixes; ``psi_scores`` is :meth:`score`'s output for
        ``state``."""
        token_idx = token_idx.to(torch.long).contiguous()
        r, psi = ctc_prefix_update(
            self.x, self.x_blank, state.r, state.psi, state.last_token,
            psi_scores.contiguous(), beam_idx.to(torch.long).contiguous(),
            token_idx, state.prefix_len, self.K)
        return CTCScorerState(r=r, psi=psi, last_token=token_idx,
                              prefix_len=state.prefix_len + 1)
