"""Generate idx2wav_len / idx2text_len files.

Rebuild of reference ``datasets/pyscripts/data_len_generator.py``.

A copy of
``speechain_tpu/pyscripts/data_len_generator.py`` on the port's utilities:
the same flags and the same output files; host code only.
"""

from __future__ import annotations

import argparse
import os

from speechain_tpu_torch.utils.fileio import (
    read_data_by_path,
    read_idx2data_file,
    write_idx2data_file,
)


def main(argv=None):
    p = argparse.ArgumentParser()
    p.add_argument("--data_path", required=True,
                   help="idx2wav (audio lengths) or idx2text (token counts)")
    p.add_argument("--save_path", default=None)
    p.add_argument("--is_text", action="store_true")
    args = p.parse_args(argv)

    data = read_idx2data_file(args.data_path)
    if args.is_text:
        lens = {k: len(v) for k, v in data.items()}
        default_name = os.path.basename(args.data_path) + "_len"
    else:
        lens = {k: len(read_data_by_path(v).reshape(-1))
                for k, v in data.items()}
        default_name = "idx2wav_len"
    save = args.save_path or os.path.join(
        os.path.dirname(os.path.abspath(args.data_path)), default_name)
    write_idx2data_file(lens, save)
    print(f"wrote {len(lens)} lengths to {save}")


if __name__ == "__main__":
    main()
