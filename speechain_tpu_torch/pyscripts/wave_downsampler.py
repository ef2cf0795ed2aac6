"""Batch waveform downsampling: idx2wav -> resampled wavs + new idx2wav.

Rebuild of reference ``datasets/pyscripts/wave_downsampler.py``: polyphase
resampling (scipy's ``resample_poly``, ``utils/fileio.py::resample``).

A copy of
``speechain_tpu/pyscripts/wave_downsampler.py`` on the port's utilities:
the same flags and the same output files; host code only.
"""

from __future__ import annotations

import argparse
import os

import numpy as np

from speechain_tpu_torch.utils.fileio import (
    read_data_by_path,
    read_idx2data_file,
    resample,
    write_idx2data_file,
    write_wav,
)


def main(argv=None):
    p = argparse.ArgumentParser()
    p.add_argument("--wav_path", required=True)
    p.add_argument("--save_path", required=True)
    p.add_argument("--sample_rate", type=int, required=True)
    args = p.parse_args(argv)

    idx2wav = read_idx2data_file(args.wav_path)
    os.makedirs(args.save_path, exist_ok=True)
    new_idx2wav, new_len = {}, {}
    for idx, path in idx2wav.items():
        wave, sr = read_data_by_path(path, return_sample_rate=True)
        wave = resample(wave.reshape(-1), sr, args.sample_rate)
        out = os.path.join(args.save_path, f"{idx}.wav")
        write_wav(out, wave, args.sample_rate)
        new_idx2wav[idx] = out
        new_len[idx] = len(wave)
    write_idx2data_file(new_idx2wav, os.path.join(args.save_path, "idx2wav"))
    write_idx2data_file(new_len,
                        os.path.join(args.save_path, "idx2wav_len"))
    print(f"resampled {len(new_idx2wav)} files to {args.sample_rate} Hz")


if __name__ == "__main__":
    main()
