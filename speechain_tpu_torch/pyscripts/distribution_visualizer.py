"""Histogram visualizers for dataset statistics.

Rebuild of reference ``speechain/pyscripts`` distribution visualizers
(text-length / wave-length / phoneme-duration histograms): read an idx2
metadata file and plot its value distribution.

A copy of
``speechain_tpu/pyscripts/distribution_visualizer.py`` on the port's utilities:
the same flags and the same output files; host code only.
"""

from __future__ import annotations

import argparse
import os

import numpy as np

from speechain_tpu_torch.utils.fileio import read_idx2data_file


def main(argv=None):
    p = argparse.ArgumentParser()
    p.add_argument("--data_path", required=True,
                   help="idx2wav_len / idx2text_len / idx2duration file")
    p.add_argument("--save_path", default=None)
    p.add_argument("--bins", type=int, default=50)
    p.add_argument("--mode", default="scalar",
                   choices=["scalar", "text_len", "duration"])
    args = p.parse_args(argv)

    import matplotlib
    matplotlib.use("Agg")
    import matplotlib.pyplot as plt

    data = read_idx2data_file(args.data_path)
    if args.mode == "scalar":
        values = np.asarray([float(v) for v in data.values()])
    elif args.mode == "text_len":
        values = np.asarray([len(str(v).split()) for v in data.values()])
    else:  # duration: flatten all per-token frame counts
        values = np.concatenate(
            [np.asarray([float(d) for d in str(v).split()])
             for v in data.values()])

    fig, ax = plt.subplots(figsize=(8, 5))
    ax.hist(values, bins=args.bins)
    ax.set_title(os.path.basename(args.data_path))
    ax.set_xlabel("value")
    ax.set_ylabel("count")
    stats = (f"n={len(values)} mean={values.mean():.1f} "
             f"p50={np.percentile(values, 50):.1f} "
             f"p95={np.percentile(values, 95):.1f} max={values.max():.1f}")
    ax.text(0.98, 0.95, stats, transform=ax.transAxes, ha="right")
    save = args.save_path or args.data_path + "_hist.png"
    fig.savefig(save, dpi=100)
    print(f"saved {save} ({stats})")


if __name__ == "__main__":
    main()
