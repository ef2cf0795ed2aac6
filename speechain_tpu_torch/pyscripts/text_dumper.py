"""Apply a txt_format normalization profile to raw transcripts.

The reference bakes normalized text into ``idx2{txt_format}_text`` files at
dump time (datasets/meta_generator.py + utilbox/dump_util.py); this script
does the same with the parity-tested normalizer
(speechain_tpu_torch.utils.textnorm).

A copy of
``speechain_tpu/pyscripts/text_dumper.py`` on the port's utilities:
the same flags and the same output files; host code only.
"""

from __future__ import annotations

import argparse
import os

from speechain_tpu_torch.utils.fileio import (read_idx2data_file,
                                              write_idx2data_file)
from speechain_tpu_torch.utils.textnorm import en_text_process


def main(argv=None):
    p = argparse.ArgumentParser()
    p.add_argument("--text_path", required=True, help="raw idx2text")
    p.add_argument("--txt_format", default="no-punc",
                   choices=["punc", "no-punc"])
    p.add_argument("--save_path", default=None)
    args = p.parse_args(argv)

    idx2text = read_idx2data_file(args.text_path)
    out = {idx: en_text_process(t, args.txt_format)
           for idx, t in idx2text.items()}
    save = args.save_path or os.path.join(
        os.path.dirname(os.path.abspath(args.text_path)),
        f"idx2{args.txt_format}_text")
    write_idx2data_file(out, save)
    print(f"normalized {len(out)} transcripts -> {save}")


if __name__ == "__main__":
    main()
