"""Objective TTS evaluation: MCD / MSD / log-F0 RMSE between synthesized
and reference audio.

Counterpart of ``speechain_tpu/pyscripts/tts_evaluation.py``: takes two
idx2wav files (hypothesis and reference), computes each utterance's
mel-cepstral distortion, mel-spectral distortion and log-F0 RMSE over the
frames voiced in both tracks (``utils/tts_eval.py``), and writes
``idx2{metric}`` files and an ``overall_results.md`` with mean, std and
the top-N worst utterances::

    python -m speechain_tpu_torch.pyscripts.tts_evaluation \\
        --hypo_path synth/idx2wav --refer_path data/idx2wav \\
        [--metric_list mcd,msd] [--device cpu]

The log-Mel features run on the card's log-Mel kernel unless
``--device cpu``; the DTW and the pitch tracker run on the host.
"""

from __future__ import annotations

import argparse
import functools
import os
from typing import Dict

import numpy as np

from speechain_tpu_torch.utils import tts_eval
from speechain_tpu_torch.utils.device import resolve_device
from speechain_tpu_torch.utils.fileio import (read_data_by_path,
                                              read_idx2data_file, resample)
from speechain_tpu_torch.utils.reports import (md_table, topn_bad_cases,
                                               write_idx2_file)


def main(argv=None):
    p = argparse.ArgumentParser(description=__doc__)
    p.add_argument("--hypo_path", required=True,
                   help="idx2wav of synthesized audio (or a folder holding "
                        "one named idx2wav)")
    p.add_argument("--refer_path", required=True,
                   help="idx2wav of ground-truth audio")
    p.add_argument("--result_path", default=None,
                   help="output dir; defaults to dirname(hypo_path)")
    p.add_argument("--metric_list", default="mcd,msd,log_f0_rmse",
                   help="comma list out of mcd,msd,log_f0_rmse")
    p.add_argument("--topn_num", type=int, default=30)
    p.add_argument("--device", default="cuda",
                   help="cuda (default) or cpu")
    args = p.parse_args(argv)

    hypo_path = args.hypo_path
    if os.path.isdir(hypo_path):
        hypo_path = os.path.join(hypo_path, "idx2wav")
    idx2hypo = read_idx2data_file(hypo_path)
    idx2refer = read_idx2data_file(args.refer_path)
    result_path = args.result_path or os.path.dirname(os.path.abspath(hypo_path))
    metrics = [m.strip() for m in args.metric_list.split(",") if m.strip()]

    device = resolve_device(args.device)
    fns = {"mcd": functools.partial(tts_eval.mcd, device=device),
           "msd": functools.partial(tts_eval.msd, device=device),
           "log_f0_rmse": tts_eval.log_f0_rmse}
    unknown = [m for m in metrics if m not in fns]
    if unknown:
        raise ValueError(f"unknown metrics {unknown}; pick from {list(fns)}")

    results: Dict[str, Dict[str, float]] = {m: {} for m in metrics}
    shared = [i for i in idx2hypo if i in idx2refer]
    for idx in shared:
        h_wav, h_sr = read_data_by_path(idx2hypo[idx], return_sample_rate=True)
        r_wav, r_sr = read_data_by_path(idx2refer[idx], return_sample_rate=True)
        h_wav, r_wav = np.asarray(h_wav).reshape(-1), np.asarray(r_wav).reshape(-1)
        if h_sr != r_sr:
            # compare at the lower rate
            if h_sr > r_sr:
                h_wav, h_sr = resample(h_wav, h_sr, r_sr), r_sr
            else:
                r_wav, r_sr = resample(r_wav, r_sr, h_sr), h_sr
        for m in metrics:
            val = fns[m](h_wav, r_wav, h_sr)
            if val is not None:
                results[m][idx] = float(val)

    os.makedirs(result_path, exist_ok=True)
    lines = ["# TTS objective evaluation", "",
             f"{len(shared)} utterances evaluated "
             f"({len(idx2hypo) - len(shared)} hypo indices missing a reference)",
             ""]
    rows = []
    for m in metrics:
        vals = np.array(list(results[m].values()), np.float64)
        write_idx2_file({k: f"{v:.4f}" for k, v in results[m].items()},
                        os.path.join(result_path, f"idx2{m}"))
        rows.append([m, len(vals),
                     f"{vals.mean():.4f}" if len(vals) else "n/a",
                     f"{vals.std():.4f}" if len(vals) else "n/a"])
    lines.append(md_table(["metric", "#utts", "mean", "std"], rows))
    lines.append("")
    for m in metrics:
        lines.append(f"## Top-{args.topn_num} worst by {m}")
        lines.append(md_table(
            ["idx", m],
            [[i, f"{v:.4f}"]
             for i, v in topn_bad_cases(results[m], args.topn_num)]))
        lines.append("")
    with open(os.path.join(result_path, "overall_results.md"), "w",
              encoding="utf-8") as f:
        f.write("\n".join(lines))
    print(f"wrote {result_path}/overall_results.md "
          f"({', '.join(f'{r[0]}={r[2]}' for r in rows)})")
    return results


if __name__ == "__main__":
    main()
