"""Generate MFA .lab transcript files next to audio.

Rebuild of reference ``datasets/pyscripts/lab_file_generator.py``: one .lab
per utterance (same basename as the wav) containing the transcript, the
layout the Montreal Forced Aligner consumes for FastSpeech2 durations.

A copy of
``speechain_tpu/pyscripts/lab_file_generator.py`` on the port's utilities:
the same flags and the same output files; host code only.
"""

from __future__ import annotations

import argparse
import os

from speechain_tpu_torch.utils.fileio import read_idx2data_file


def main(argv=None):
    p = argparse.ArgumentParser()
    p.add_argument("--wav_path", required=True, help="idx2wav file")
    p.add_argument("--text_path", required=True, help="idx2text file")
    p.add_argument("--save_path", default=None,
                   help="default: next to each wav file")
    args = p.parse_args(argv)

    idx2wav = read_idx2data_file(args.wav_path)
    idx2text = read_idx2data_file(args.text_path)
    n = 0
    for idx, wav in idx2wav.items():
        if idx not in idx2text:
            continue
        if args.save_path:
            os.makedirs(args.save_path, exist_ok=True)
            lab = os.path.join(args.save_path, idx + ".lab")
        else:
            lab = os.path.splitext(wav)[0] + ".lab"
        with open(lab, "w", encoding="utf-8") as f:
            f.write(idx2text[idx] + "\n")
        n += 1
    print(f"wrote {n} .lab files")


if __name__ == "__main__":
    main()
