"""Summarize a directory tree into an idx2path file.

Rebuild of reference ``speechain/pyscripts/folder_summarizer.py``: walk a
folder, collect files matching an extension, key them by basename.

A copy of
``speechain_tpu/pyscripts/folder_summarizer.py`` on the port's utilities:
the same flags and the same output files; host code only.
"""

from __future__ import annotations

import argparse
import os

from speechain_tpu_torch.utils.fileio import write_idx2data_file


def main(argv=None):
    p = argparse.ArgumentParser()
    p.add_argument("--src_folder", required=True)
    p.add_argument("--save_path", default=None)
    p.add_argument("--ext", default="wav")
    p.add_argument("--name", default=None,
                   help="output file name (default idx2<ext>)")
    args = p.parse_args(argv)

    idx2path = {}
    for root, _, files in os.walk(args.src_folder):
        for f in sorted(files):
            if f.endswith("." + args.ext):
                idx2path[os.path.splitext(f)[0]] = os.path.abspath(
                    os.path.join(root, f))
    name = args.name or f"idx2{args.ext}"
    save = os.path.join(args.save_path or args.src_folder, name)
    write_idx2data_file(idx2path, save)
    print(f"wrote {len(idx2path)} entries to {save}")


if __name__ == "__main__":
    main()
