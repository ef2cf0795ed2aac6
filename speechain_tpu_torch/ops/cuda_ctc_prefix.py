"""CTC prefix scoring kernels (``csrc/ctc_prefix.cu``) and their plain
PyTorch versions.

Port-only kernels: the reference runs :class:`CTCPrefixScorer`'s two
recursions over frames as ``lax.scan`` (``speechain_tpu/infer/
ctc_scorer.py``: ``score`` :75, scan at :107; ``update_state`` :118, scan
at :148), which XLA compiles into one loop on the device. Here a plain
PyTorch loop over frames costs ~10 launches a frame (about 2,000 a decode
step at T_enc 199), so each recursion is one kernel launch a step.

:func:`ctc_prefix_score` returns the (BK, V) incremental scores
psi(g + v) - psi(g) of every one-token extension of the BK current
prefixes; :func:`ctc_prefix_update` rebuilds the (T, 2, BK) lattice of the
chosen prefixes. A CPU tensor takes the plain version; a CUDA tensor takes
the kernel, or raises. The plain versions run the reference's recursions
frame by frame; the kernels compute the same functions in another order
(``csrc/ctc_prefix.cu``): the score as one log-sum-exp over frames a
column, the update as a scan of log-semiring maps across a warp's lanes.

Bounds on the H100 (float32 throughout): the score's function is 5
operations a (row, token, frame) (add, max, subtract, exp, add), 0.25
GFLOP at conformer-small's decode step (BK 256, T 199, V 1000), 3.8 us at
67 TFLOP/s, level with its 12.7 MB of input (3.8 us); its one exp2 a
column-frame on the special-function units (16 an SM a clock) takes ~12
us at 1.98 GHz. The update does 24 operations a (row, frame), moves ~1.2
MB and does ~1.2 MFLOP, and is latency-bound; its logaddexps run on the
special-function units, within ~2e-7 of the reference's formula.
"""

from __future__ import annotations

import torch

from speechain_tpu_torch.ops.cuda_build import (CudaKernel, I, P,
                                                check_cuda_args, stream_ptr)

NEG_INF = -1e20
# the update kernel stages 3 T floats a row, UPDATE_WARPS rows a block, in
# the card's 227 KB of shared memory a block: the longest T it takes
UPDATE_WARPS = 4
UPDATE_MAX_FRAMES = 227 * 1024 // (4 * 3 * UPDATE_WARPS)

KERNEL = CudaKernel(
    name="ctc_prefix", source="ctc_prefix.cu",
    symbols={"ctc_prefix_score": [P] * 7 + [I] * 7 + [P],
             "ctc_prefix_update": [P] * 10 + [I] * 5 + [P]},
    replaces={"ctc_prefix_score": "speechain_tpu/infer/ctc_scorer.py:107",
              "ctc_prefix_update": "speechain_tpu/infer/ctc_scorer.py:148"})


def logaddexp(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """max(a, b) + log1p(exp(-|a - b|)): the reference's formula (finite
    for the finite NEG_INF), and the kernels'."""
    return torch.maximum(a, b) + torch.log1p(torch.exp(-(a - b).abs()))


def ctc_prefix_score_plain(x, x_blank, enc_len, r, psi, last_token,
                           prefix_len: int, K: int, blank_id: int,
                           eos_id: int) -> torch.Tensor:
    """The score kernel's function in plain PyTorch, frame by frame; x is
    read a frame at a time by utterance (no (BK, T, V) gather)."""
    B, T, V = x.shape
    BK = B * K
    dev = x.device
    row = torch.arange(BK, device=dev) // K
    r_sum = logaddexp(r[:, 0], r[:, 1])                       # (T, BK)
    is_last = last_token[:, None] == torch.arange(V, device=dev)[None]
    xb = x_blank[row]                                         # (BK, T)
    neg = torch.full((BK, V), NEG_INF, dtype=torch.float32, device=dev)

    r_nb = x[:, 0][row] if prefix_len == 0 else neg
    r_b = neg
    start = max(prefix_len, 1)
    psi_acc = neg
    psi_init = r_nb if start == 1 else neg
    for t in range(1, T):
        phi = torch.where(is_last, r[t - 1, 1][:, None],
                          r_sum[t - 1][:, None])
        xt = x[:, t][row]
        if t == start:
            psi_init = r_nb
        r_nb, r_b, psi_acc = (logaddexp(r_nb, phi) + xt,
                              logaddexp(r_nb, r_b) + xb[:, t, None],
                              logaddexp(psi_acc, phi + xt))
    out = logaddexp(psi_acc, psi_init)
    last = enc_len.long()[row] - 1
    last = torch.where(last < 0, last + T, last)
    out[:, eos_id] = r_sum[last, torch.arange(BK, device=dev)]
    out[:, blank_id] = NEG_INF
    return out - psi[:, None]


def ctc_prefix_update_plain(x, x_blank, r, psi, last_token, scores,
                            beam_idx, token, prefix_len: int, K: int):
    """The update kernel's function in plain PyTorch: (r_new (T, 2, BK),
    psi_new (BK,)) of the prefixes ``beam_idx`` extended by ``token``."""
    B, T, V = x.shape
    BK = B * K
    dev = x.device
    row = torch.arange(BK, device=dev) // K
    r_old = r[:, :, beam_idx]
    r_sum_old = logaddexp(r_old[:, 0], r_old[:, 1])           # (T, BK)
    x_tok = x[row[:, None], torch.arange(T, device=dev)[None],
              token[:, None]].T                               # (T, BK)
    xb = x_blank[row].T
    is_rep = token == last_token[beam_idx]
    r_nb = (x_tok[0] if prefix_len == 0 else
            torch.full((BK,), NEG_INF, dtype=torch.float32, device=dev))
    r_b = torch.full((BK,), NEG_INF, dtype=torch.float32, device=dev)
    nbs, bs = [r_nb], [r_b]
    for t in range(1, T):
        phi = torch.where(is_rep, r_old[t - 1, 1], r_sum_old[t - 1])
        r_nb, r_b = (logaddexp(r_nb, phi) + x_tok[t],
                     logaddexp(r_nb, r_b) + xb[t])
        nbs.append(r_nb)
        bs.append(r_b)
    r_new = torch.stack([torch.stack(nbs), torch.stack(bs)], 1)
    return r_new, psi[beam_idx] + scores[beam_idx, token]


def ctc_prefix_score(x, x_blank, enc_len, r, psi, last_token,
                     prefix_len: int, K: int, blank_id: int,
                     eos_id: int) -> torch.Tensor:
    """(BK, V) float32 incremental scores psi(g + v) - psi(g); the eos
    column holds the prefix's total at its utterance's last valid frame,
    the blank column NEG_INF - psi(g).

    x (B, T, V) and x_blank (B, T) float32 (frames past ``enc_len``
    masked); enc_len (B,); r (T, 2, BK) and psi (BK,) float32; last_token
    (BK,) int64, -1 for an empty prefix."""
    if not x.is_cuda:
        return ctc_prefix_score_plain(x, x_blank, enc_len, r, psi,
                                      last_token, prefix_len, K, blank_id,
                                      eos_id)
    B, T, V = x.shape
    _check(x, x_blank, r, psi, K)
    check_cuda_args("ctc_prefix_score", {
        "enc_len": (torch.int64,), "last_token": (torch.int64,),
        "*": (torch.float32,)}, x=x, x_blank=x_blank, enc_len=enc_len, r=r,
        psi=psi, last_token=last_token)
    out = torch.empty(B * K, V, dtype=torch.float32, device=x.device)
    KERNEL.launch("ctc_prefix_score", x.data_ptr(), x_blank.data_ptr(),
                  enc_len.data_ptr(), r.data_ptr(), psi.data_ptr(),
                  last_token.data_ptr(), out.data_ptr(), B, K, T, V,
                  int(prefix_len), int(blank_id), int(eos_id), stream_ptr(x))
    return out


def ctc_prefix_update(x, x_blank, r, psi, last_token, scores, beam_idx,
                      token, prefix_len: int, K: int):
    """(r_new (T, 2, BK), psi_new (BK,)) float32: the lattice and score of
    each prefix ``beam_idx[i]`` extended by ``token[i]``; ``scores`` is
    :func:`ctc_prefix_score`'s output for the current prefixes and
    ``prefix_len`` their length. beam_idx and token int64, in range. On
    the card T is at most UPDATE_MAX_FRAMES (4,842 encoder frames); a
    longer T raises a ValueError."""
    if not x.is_cuda:
        return ctc_prefix_update_plain(x, x_blank, r, psi, last_token,
                                       scores, beam_idx, token, prefix_len,
                                       K)
    B, T, V = x.shape
    _check(x, x_blank, r, psi, K)
    if T > UPDATE_MAX_FRAMES:
        raise ValueError(f"ctc_prefix_update: T {T} frames, the kernel "
                         f"takes at most {UPDATE_MAX_FRAMES}")
    if tuple(scores.shape) != (B * K, V):
        raise ValueError(f"ctc_prefix_update: scores {tuple(scores.shape)}, "
                         f"expected {(B * K, V)}")
    check_cuda_args("ctc_prefix_update", {
        "last_token": (torch.int64,), "beam_idx": (torch.int64,),
        "token": (torch.int64,), "*": (torch.float32,)}, x=x,
        x_blank=x_blank, r=r, psi=psi, last_token=last_token, scores=scores,
        beam_idx=beam_idx, token=token)
    r_new = torch.empty_like(r)
    psi_new = torch.empty_like(psi)
    KERNEL.launch("ctc_prefix_update", x.data_ptr(), x_blank.data_ptr(),
                  r.data_ptr(), psi.data_ptr(), last_token.data_ptr(),
                  scores.data_ptr(), beam_idx.data_ptr(), token.data_ptr(),
                  r_new.data_ptr(), psi_new.data_ptr(), B, K, T, V,
                  int(prefix_len), stream_ptr(x))
    return r_new, psi_new


def _check(x, x_blank, r, psi, K: int) -> None:
    B, T, V = x.shape
    BK = B * K
    for name, t, shape in (("x_blank", x_blank, (B, T)), ("r", r, (T, 2, BK)),
                           ("psi", psi, (BK,))):
        if tuple(t.shape) != shape:
            raise ValueError(f"ctc_prefix: {name} {tuple(t.shape)}, expected "
                             f"{shape}")

