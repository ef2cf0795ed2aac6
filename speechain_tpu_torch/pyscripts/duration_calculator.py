"""MFA TextGrid -> phoneme duration files for FastSpeech2.

Rebuild of reference ``datasets/pyscripts/duration_calculator.py:136``:
parses Praat TextGrid files produced by the Montreal Forced Aligner, reads
the 'phones' tier, converts interval times to frame counts at the TTS
frontend hop (12.5 ms default), and writes idx2duration (space-separated
frame counts) + idx2text (phoneme list format "['P1', 'P2', ...]").

A copy of
``speechain_tpu/pyscripts/duration_calculator.py`` on the port's utilities:
the same flags and the same output files; host code only.
"""

from __future__ import annotations

import argparse
import os
import re
from typing import List, Tuple


def parse_textgrid(path: str, tier_name: str = "phones"
                   ) -> List[Tuple[float, float, str]]:
    """Minimal TextGrid parser: returns (xmin, xmax, label) intervals of the
    requested tier (both long and short TextGrid formats handled for the
    common MFA output)."""
    with open(path, "r", encoding="utf-8") as f:
        content = f.read()
    # find the tier block
    tiers = re.split(r'item\s*\[\d+\]:', content)
    target = None
    for tier in tiers[1:]:
        m = re.search(r'name\s*=\s*"([^"]*)"', tier)
        if m and m.group(1) == tier_name:
            target = tier
            break
    if target is None:
        raise ValueError(f"tier {tier_name!r} not found in {path}")
    intervals = []
    for m in re.finditer(
            r'intervals\s*\[\d+\]:\s*xmin\s*=\s*([\d.]+)\s*'
            r'xmax\s*=\s*([\d.]+)\s*text\s*=\s*"([^"]*)"', target):
        intervals.append((float(m.group(1)), float(m.group(2)), m.group(3)))
    return intervals


def intervals_to_durations(intervals, hop_length: float
                           ) -> Tuple[List[str], List[int]]:
    """Quantize interval boundaries to frames (cumulative rounding so the
    total matches the utterance length)."""
    phonemes, durations = [], []
    prev_frames = 0
    for xmin, xmax, label in intervals:
        label = label if label else "<space>"  # silence/blank intervals
        end_frames = int(round(xmax / hop_length))
        phonemes.append(label)
        durations.append(max(end_frames - prev_frames, 0))
        prev_frames = end_frames
    return phonemes, durations


def main(argv=None):
    p = argparse.ArgumentParser()
    p.add_argument("--textgrid_path", required=True,
                   help="directory of .TextGrid files (searched recursively)")
    p.add_argument("--save_path", required=True)
    p.add_argument("--hop_length", type=float, default=0.0125)
    p.add_argument("--tier", default="phones")
    args = p.parse_args(argv)

    idx2duration, idx2text = {}, {}
    for root, _, files in os.walk(args.textgrid_path):
        for name in files:
            if not name.endswith(".TextGrid"):
                continue
            idx = name[: -len(".TextGrid")]
            intervals = parse_textgrid(os.path.join(root, name), args.tier)
            phonemes, durations = intervals_to_durations(
                intervals, args.hop_length)
            idx2duration[idx] = " ".join(str(d) for d in durations)
            idx2text[idx] = "[" + ", ".join(
                f"'{ph}'" for ph in phonemes) + "]"
    os.makedirs(args.save_path, exist_ok=True)
    from speechain_tpu_torch.utils.fileio import write_idx2data_file
    write_idx2data_file(idx2duration,
                        os.path.join(args.save_path, "idx2duration"))
    write_idx2data_file(idx2text,
                        os.path.join(args.save_path, "idx2mfa_text"))
    print(f"parsed {len(idx2duration)} TextGrids into {args.save_path}")


if __name__ == "__main__":
    main()
