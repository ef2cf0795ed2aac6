"""Markdown tables and idx2 files for evaluation reports.

A copy of the parts of ``speechain_tpu/utils/reports.py`` that the
evaluation entry points use.
"""

from __future__ import annotations

from typing import Dict, List, Sequence

# the JAX package has two copies of this writer; the port keeps one
from speechain_tpu_torch.utils.fileio import \
    write_idx2data_file as write_idx2_file  # noqa: F401


def md_table(headers: Sequence[str], rows: Sequence[Sequence]) -> str:
    """GitHub-style markdown table."""
    out = ["|" + "|".join(str(h) for h in headers) + "|",
           "|" + "|".join("---" for _ in headers) + "|"]
    for row in rows:
        out.append("|" + "|".join(str(c) for c in row) + "|")
    return "\n".join(out)


def topn_bad_cases(idx2metric: Dict[str, float], n: int = 10,
                   mode: str = "max") -> List:
    """Top-N worst utterances by a metric ('max': the largest first)."""
    items = sorted(idx2metric.items(), key=lambda kv: kv[1],
                   reverse=(mode == "max"))
    return items[:n]
