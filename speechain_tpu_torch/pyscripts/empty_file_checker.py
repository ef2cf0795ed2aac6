"""Check an idx2path file for missing/empty/corrupt data files.

Rebuild of reference ``speechain/pyscripts/empty_file_checker.py``.

A copy of
``speechain_tpu/pyscripts/empty_file_checker.py`` on the port's utilities:
the same flags and the same output files; host code only.
"""

from __future__ import annotations

import argparse
import os

from speechain_tpu_torch.utils.fileio import read_idx2data_file


def main(argv=None):
    p = argparse.ArgumentParser()
    p.add_argument("--data_path", required=True, help="idx2path file")
    p.add_argument("--delete_bad", action="store_true",
                   help="rewrite the idx2 file without bad entries")
    args = p.parse_args(argv)

    idx2path = read_idx2data_file(args.data_path)
    bad = []
    for idx, path in idx2path.items():
        real = path.split(":")[0] if ":" in path and not os.path.exists(
            path) else path
        if not os.path.exists(real) or os.path.getsize(real) == 0:
            bad.append(idx)
    print(f"{len(bad)} bad entries out of {len(idx2path)}")
    for idx in bad[:20]:
        print(" ", idx, idx2path[idx])
    if args.delete_bad and bad:
        from speechain_tpu_torch.utils.fileio import write_idx2data_file
        for idx in bad:
            idx2path.pop(idx)
        write_idx2data_file(idx2path, args.data_path)
        print(f"rewrote {args.data_path} with {len(idx2path)} entries")


if __name__ == "__main__":
    main()
