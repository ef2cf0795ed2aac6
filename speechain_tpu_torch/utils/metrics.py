"""A copy of ``speechain_tpu/utils/metrics.py``.

Host-side evaluation metrics: CER/WER via Levenshtein alignment.

Rebuild of reference ``criterion/error_rate.py:36`` (editdistance-based
CER+WER) and ``utilbox/eval_util.py:12`` (word alignment tables with
insertion/deletion/substitution counts). The ``editdistance`` pip package is
not a dependency, so the DP is implemented here directly (numpy,
host-side only).
"""

from __future__ import annotations

from typing import Dict, List, Sequence, Tuple

import numpy as np


def levenshtein_alignment(hypo: Sequence, real: Sequence) -> Dict:
    """Edit distance with backtraced op counts.

    Returns dict(dist, insert, delete, substitute, align) where ``align`` is
    a list of (op, hypo_token, real_token) tuples, op in {'ok','sub','ins',
    'del'}; 'ins' = token present in hypo but not real.
    """
    H, R = len(hypo), len(real)
    dist = np.zeros((H + 1, R + 1), dtype=np.int32)
    dist[:, 0] = np.arange(H + 1)
    dist[0, :] = np.arange(R + 1)
    for i in range(1, H + 1):
        for j in range(1, R + 1):
            sub = dist[i - 1, j - 1] + (hypo[i - 1] != real[j - 1])
            dist[i, j] = min(sub, dist[i - 1, j] + 1, dist[i, j - 1] + 1)
    # backtrace
    i, j = H, R
    align: List[Tuple[str, object, object]] = []
    n_ins = n_del = n_sub = 0
    while i > 0 or j > 0:
        if i > 0 and j > 0 and dist[i, j] == dist[i - 1, j - 1] + (
                hypo[i - 1] != real[j - 1]):
            if hypo[i - 1] == real[j - 1]:
                align.append(("ok", hypo[i - 1], real[j - 1]))
            else:
                align.append(("sub", hypo[i - 1], real[j - 1]))
                n_sub += 1
            i, j = i - 1, j - 1
        elif i > 0 and dist[i, j] == dist[i - 1, j] + 1:
            align.append(("ins", hypo[i - 1], None))
            n_ins += 1
            i -= 1
        else:
            align.append(("del", None, real[j - 1]))
            n_del += 1
            j -= 1
    align.reverse()
    return dict(dist=int(dist[H, R]), insert=n_ins, delete=n_del,
                substitute=n_sub, align=align)


def edit_distance(hypo: Sequence, real: Sequence) -> int:
    H, R = len(hypo), len(real)
    if H == 0:
        return R
    if R == 0:
        return H
    prev = np.arange(R + 1, dtype=np.int64)
    h = np.asarray(hypo)
    r = np.asarray(real)
    for i in range(1, H + 1):
        cur = np.empty(R + 1, dtype=np.int64)
        cur[0] = i
        sub = prev[:-1] + (h[i - 1] != r)
        # vectorized row update: cur[j] = min(sub, prev[j] + 1, cur[j-1] + 1)
        cur[1:] = np.minimum(sub, prev[1:] + 1)
        for j in range(1, R + 1):
            if cur[j - 1] + 1 < cur[j]:
                cur[j] = cur[j - 1] + 1
        prev = cur
    return int(prev[R])


def cer(hypo_text: str, real_text: str) -> float:
    """Character error rate (error_rate.py:36-80): edit distance over
    characters (spaces included like the reference) / len(real)."""
    h = list(hypo_text)
    r = list(real_text)
    return edit_distance(h, r) / max(len(r), 1)


def wer(hypo_text: str, real_text: str) -> float:
    """Word error rate: edit distance over whitespace-split words."""
    h = hypo_text.split()
    r = real_text.split()
    return edit_distance(h, r) / max(len(r), 1)


def batch_error_rates(hypo_texts: Sequence[str], real_texts: Sequence[str]):
    """Per-utterance (cer, wer) lists plus word alignments."""
    cers, wers, aligns = [], [], []
    for h, r in zip(hypo_texts, real_texts):
        cers.append(cer(h, r))
        wers.append(wer(h, r))
        aligns.append(levenshtein_alignment(h.split(), r.split()))
    return cers, wers, aligns
