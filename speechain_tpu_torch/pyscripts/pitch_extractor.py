"""Offline pitch (F0) extraction: idx2wav -> .npy pitch tracks + idx2pitch.

Parity path for the reference's pyworld dio+stonemask pipeline
(``utilbox/feat_util.py:256`` / dataset/speech_text.py:95-104): DIO
candidate search + StoneMask instantaneous-frequency refinement +
ESPnet-style continuous-F0 interpolation, implemented in
``speechain_tpu_torch.utils.world_pitch`` (pyworld itself is not available in
this image). Frame rate matches the TTS frontend (12.5 ms hop).

A copy of
``speechain_tpu/pyscripts/pitch_extractor.py`` on the port's utilities:
the same flags and the same output files; host code only.
"""

from __future__ import annotations

import argparse
import os

import numpy as np

from speechain_tpu_torch.utils.fileio import (
    read_data_by_path,
    read_idx2data_file,
    write_idx2data_file,
)
from speechain_tpu_torch.utils.world_pitch import convert_wav_to_pitch


def main(argv=None):
    p = argparse.ArgumentParser()
    p.add_argument("--wav_path", required=True)
    p.add_argument("--save_path", required=True)
    p.add_argument("--sr", type=int, default=16000)
    p.add_argument("--hop_length", type=float, default=0.0125)
    p.add_argument("--f0min", type=float, default=80.0)
    p.add_argument("--f0max", type=float, default=400.0)
    p.add_argument("--continuous_f0", type=lambda s: s.lower() != "false",
                   default=True)
    args = p.parse_args(argv)

    idx2wav = read_idx2data_file(args.wav_path)
    os.makedirs(args.save_path, exist_ok=True)
    idx2pitch = {}
    for idx, path in idx2wav.items():
        wave = read_data_by_path(path).reshape(-1)
        f0 = convert_wav_to_pitch(
            wave, hop_length=args.hop_length, sr=args.sr,
            f0min=args.f0min, f0max=args.f0max,
            do_continuous_f0=args.continuous_f0)
        out = os.path.join(args.save_path, f"{idx}.npy")
        np.save(out, f0.astype(np.float32))
        idx2pitch[idx] = out
    write_idx2data_file(idx2pitch, os.path.join(args.save_path, "idx2pitch"))
    print(f"extracted {len(idx2pitch)} pitch tracks to {args.save_path}")


if __name__ == "__main__":
    main()
