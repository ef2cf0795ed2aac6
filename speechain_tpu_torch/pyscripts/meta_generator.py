"""Dataset metadata generation: raw corpus layouts -> idx2wav / idx2text /
idx2spk (+ gender when available) trees.

Rebuild of reference ``datasets/meta_generator.py:16`` and its per-dataset
subclasses (``datasets/{librispeech,libritts,ljspeech,vctk}/``): walks the
corpus's native directory layout and emits the reference's idx2* file
contract, with text normalized per ``--txt_format`` profiles
(utils/textnorm parity).

Usage::

    python -m speechain_tpu_torch.pyscripts.meta_generator \
        --dataset librispeech --src_path LibriSpeech/train-clean-100 \
        --save_path data/train-clean-100

A copy of
``speechain_tpu/pyscripts/meta_generator.py`` on the port's utilities:
the same flags and the same output files; host code only.
"""

from __future__ import annotations

import argparse
import csv
import os
from typing import Dict, Tuple

from speechain_tpu_torch.utils.fileio import write_idx2data_file
from speechain_tpu_torch.utils.textnorm import en_text_process


def scan_librispeech(src: str) -> Tuple[Dict, Dict, Dict]:
    """{split}/{spk}/{chap}/{spk-chap-utt.flac + *.trans.txt}."""
    idx2wav, idx2text, idx2spk = {}, {}, {}
    for root, _, files in os.walk(src):
        trans = [f for f in files if f.endswith(".trans.txt")]
        for t in trans:
            with open(os.path.join(root, t), encoding="utf-8") as f:
                for line in f:
                    idx, _, text = line.rstrip("\n").partition(" ")
                    if not idx:
                        continue
                    wav = os.path.join(root, idx + ".flac")
                    if os.path.exists(wav):
                        idx2wav[idx] = os.path.abspath(wav)
                        idx2text[idx] = text
                        idx2spk[idx] = idx.split("-")[0]
    return idx2wav, idx2text, idx2spk


def scan_ljspeech(src: str) -> Tuple[Dict, Dict, Dict]:
    """metadata.csv (idx|raw|normalized) + wavs/idx.wav."""
    idx2wav, idx2text, idx2spk = {}, {}, {}
    meta = os.path.join(src, "metadata.csv")
    with open(meta, encoding="utf-8") as f:
        for row in csv.reader(f, delimiter="|", quoting=csv.QUOTE_NONE):
            if len(row) < 2:
                continue
            idx = row[0]
            text = row[2] if len(row) > 2 and row[2] else row[1]
            wav = os.path.join(src, "wavs", idx + ".wav")
            if os.path.exists(wav):
                idx2wav[idx] = os.path.abspath(wav)
                idx2text[idx] = text
                idx2spk[idx] = "LJ"
    return idx2wav, idx2text, idx2spk


def scan_libritts(src: str) -> Tuple[Dict, Dict, Dict]:
    """{spk}/{chap}/{idx.wav + idx.normalized.txt}."""
    idx2wav, idx2text, idx2spk = {}, {}, {}
    for root, _, files in os.walk(src):
        for f in files:
            if not f.endswith(".wav"):
                continue
            idx = f[:-4]
            txt = os.path.join(root, idx + ".normalized.txt")
            if not os.path.exists(txt):
                txt = os.path.join(root, idx + ".original.txt")
            if not os.path.exists(txt):
                continue
            with open(txt, encoding="utf-8") as fh:
                idx2text[idx] = fh.read().strip()
            idx2wav[idx] = os.path.abspath(os.path.join(root, f))
            idx2spk[idx] = idx.split("_")[0]
    return idx2wav, idx2text, idx2spk


def scan_vctk(src: str) -> Tuple[Dict, Dict, Dict]:
    """wav48(_silence_trimmed)?/{spk}/{idx}.wav|flac + txt/{spk}/{idx}.txt."""
    idx2wav, idx2text, idx2spk = {}, {}, {}
    wav_roots = [os.path.join(src, d) for d in
                 ("wav48_silence_trimmed", "wav48", "wav")
                 if os.path.isdir(os.path.join(src, d))]
    txt_root = os.path.join(src, "txt")
    for wav_root in wav_roots:
        for spk in sorted(os.listdir(wav_root)):
            spk_dir = os.path.join(wav_root, spk)
            if not os.path.isdir(spk_dir):
                continue
            for f in sorted(os.listdir(spk_dir)):
                if not f.endswith((".wav", ".flac")):
                    continue
                idx = os.path.splitext(f)[0].replace("_mic1", "").replace(
                    "_mic2", "")
                if idx in idx2wav:
                    continue
                txt = os.path.join(txt_root, spk, idx + ".txt")
                if not os.path.exists(txt):
                    continue
                with open(txt, encoding="utf-8") as fh:
                    idx2text[idx] = fh.read().strip()
                idx2wav[idx] = os.path.abspath(os.path.join(spk_dir, f))
                idx2spk[idx] = spk
    return idx2wav, idx2text, idx2spk


SCANNERS = dict(librispeech=scan_librispeech, ljspeech=scan_ljspeech,
                libritts=scan_libritts, vctk=scan_vctk)


def main(argv=None):
    p = argparse.ArgumentParser()
    p.add_argument("--dataset", required=True, choices=sorted(SCANNERS))
    p.add_argument("--src_path", required=True)
    p.add_argument("--save_path", required=True)
    p.add_argument("--txt_format", default=None,
                   choices=[None, "punc", "no-punc"],
                   help="also emit a normalized idx2{fmt}_text")
    args = p.parse_args(argv)

    idx2wav, idx2text, idx2spk = SCANNERS[args.dataset](args.src_path)
    os.makedirs(args.save_path, exist_ok=True)
    write_idx2data_file(idx2wav, os.path.join(args.save_path, "idx2wav"))
    write_idx2data_file(idx2text, os.path.join(args.save_path, "idx2text"))
    write_idx2data_file(idx2spk, os.path.join(args.save_path, "idx2spk"))
    if args.txt_format:
        norm = {k: en_text_process(v, args.txt_format)
                for k, v in idx2text.items()}
        write_idx2data_file(norm, os.path.join(
            args.save_path, f"idx2{args.txt_format}_text"))
    print(f"{args.dataset}: {len(idx2wav)} utterances -> {args.save_path}")


if __name__ == "__main__":
    main()
