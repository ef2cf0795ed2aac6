"""Markdown tables and idx2 files for evaluation reports.

A copy of the parts of ``speechain_tpu/utils/reports.py`` that the
evaluation entry points and the runner's test reports use: idx2 files,
``overall_results.md`` with group tables and histograms, top-N bad
cases (reference ``monitor.py:1672-1853``).
"""

from __future__ import annotations

import os
from typing import Dict, List, Optional, Sequence

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


#: reference ASR defaults (model/ar_asr.py:330-339
#: ``bad_cases_selection_init_fn``)
DEFAULT_BAD_CASES_SELECTION = [
    ["wer", "max", 30],
    ["cer", "max", 30],
    ["feat_token_len_ratio", "min", 30],
    ["feat_token_len_ratio", "max", 30],
    ["text_confid", "min", 30],
    ["text_confid", "max", 30],
]


def write_bad_case_reports(out_dir: str,
                           metrics: Dict[str, Dict[str, float]],
                           idx2hypo: Dict[str, str],
                           selection: Optional[List] = None) -> List[str]:
    """Configurable per-(metric, mode, N) bad-case reports.

    Mirrors reference monitor.py:1812-1837: each selection triple writes
    ``top{num}_{mode}_{metric}.md`` listing the N utterances that sort
    first by that metric in that mode ('max' = descending). ``selection``
    comes from ``infer_cfg.bad_cases_selection`` (a list of triples, or one
    bare triple — normalized like monitor.py:1443-1446); None applies the
    reference ASR defaults, filtered to the metrics actually present.
    Returns the written paths.
    """
    selection = (DEFAULT_BAD_CASES_SELECTION if selection is None
                 else selection)
    if selection and not isinstance(selection[0], (list, tuple)):
        selection = [selection]
    written = []
    for metric, mode, num in selection:
        data = metrics.get(metric)
        if not data:
            continue
        num = int(num)
        path = os.path.join(out_dir, f"top{num}_{mode}_{metric}.md")
        rows = [[idx, f"{val:.4f}", idx2hypo.get(idx, "")]
                for idx, val in topn_bad_cases(data, num, mode=mode)]
        os.makedirs(out_dir, exist_ok=True)
        with open(path, "w", encoding="utf-8") as f:
            f.write(f"# Top-{num} {mode} {metric}\n\n"
                    + md_table(["idx", metric, "hypothesis"], rows) + "\n")
        written.append(path)
    return written


def write_test_reports(out_dir: str, *, idx2hypo: Dict[str, str],
                       idx2cer: Dict[str, float],
                       idx2wer: Dict[str, float],
                       summary: Dict[str, float],
                       group_info: Optional[Dict[str, Dict[str, str]]] = None,
                       topn: int = 10):
    """Write the reference-style test artifact tree:

    out_dir/
      idx2hypo_text, idx2cer, idx2wer   (monitor.py:1672-1690 layout)
      overall_results.md                (:1730-1810)
    """
    os.makedirs(out_dir, exist_ok=True)
    write_idx2_file(idx2hypo, os.path.join(out_dir, "idx2hypo_text"))
    write_idx2_file({k: f"{v:.4f}" for k, v in idx2cer.items()},
                    os.path.join(out_dir, "idx2cer"))
    write_idx2_file({k: f"{v:.4f}" for k, v in idx2wer.items()},
                    os.path.join(out_dir, "idx2wer"))

    lines = ["# Overall results", ""]
    lines.append(md_table(["metric", "value"],
                          [[k, f"{v:.4f}"] for k, v in summary.items()]))
    lines.append("")

    if group_info:
        for gname, idx2group in group_info.items():
            groups: Dict[str, List[str]] = {}
            for idx, g in idx2group.items():
                if idx in idx2wer:
                    groups.setdefault(g, []).append(idx)
            rows = []
            for g, idxs in sorted(groups.items()):
                rows.append([
                    g, len(idxs),
                    f"{sum(idx2cer[i] for i in idxs) / len(idxs):.4f}",
                    f"{sum(idx2wer[i] for i in idxs) / len(idxs):.4f}"])
            lines.append(f"## Results by {gname}")
            lines.append(md_table([gname, "#utts", "cer", "wer"], rows))
            lines.append("")

    lines.append(f"## Top-{topn} bad cases (by WER)")
    rows = [[idx, f"{wer:.4f}", idx2hypo.get(idx, "")]
            for idx, wer in topn_bad_cases(idx2wer, topn)]
    lines.append(md_table(["idx", "wer", "hypothesis"], rows))

    # per-metric histograms (monitor.py:1839-1853): matplotlib png when
    # available, plus an always-on text histogram inline in the report
    for metric, data in (("cer", idx2cer), ("wer", idx2wer)):
        vals = [v for v in data.values() if isinstance(v, (int, float))]
        if not vals:
            continue
        lines.append("")
        lines.append(f"## {metric} histogram")
        lines.append("```")
        lines.extend(text_histogram(vals))
        lines.append("```")
        _save_hist_png(vals, metric, os.path.join(out_dir, "figures"))

    with open(os.path.join(out_dir, "overall_results.md"), "w",
              encoding="utf-8") as f:
        f.write("\n".join(lines) + "\n")


def text_histogram(vals: Sequence[float], bins: int = 10,
                   width: int = 40) -> List[str]:
    """Fixed-width ASCII histogram lines for the markdown report."""
    import numpy as np

    counts, edges = np.histogram(np.asarray(vals, np.float64), bins=bins)
    peak = max(int(counts.max()), 1)
    out = []
    for i, c in enumerate(counts):
        bar = "#" * max(int(round(width * c / peak)), 1 if c else 0)
        out.append(f"[{edges[i]:7.3f}, {edges[i + 1]:7.3f}) "
                   f"{int(c):5d} {bar}")
    return out


def _save_hist_png(vals: Sequence[float], metric: str, fig_dir: str):
    try:
        import matplotlib
        matplotlib.use("Agg")
        import matplotlib.pyplot as plt
    except Exception:
        return
    os.makedirs(fig_dir, exist_ok=True)
    fig, ax = plt.subplots(figsize=(6, 4))
    ax.hist(list(vals), bins=20)
    ax.set_xlabel(metric)
    ax.set_ylabel("#utterances")
    fig.tight_layout()
    fig.savefig(os.path.join(fig_dir, f"{metric}_hist.png"))
    plt.close(fig)
