"""Vocabulary generation from idx2text files.

Rebuild of reference ``datasets/pyscripts/vocab_generator.py:241`` supporting
the reference's token types and vocab layout conventions:
- char: all characters (space mapped to <space>), layout
  [<blank>, <unk>, tokens..., <sos/eos>];
- word: frequency-sorted words with optional --vocab_size cap;
- sentencepiece/subword: trains a BPE/unigram model via HF tokenizers
  (see data/tokenizer.train_subword_tokenizer).

A copy of
``speechain_tpu/pyscripts/vocab_generator.py`` on the port's utilities:
the same flags and the same output files; host code only.
"""

from __future__ import annotations

import argparse
import os
from collections import Counter

from speechain_tpu_torch.utils.fileio import read_idx2data_file


def generate_char_vocab(texts):
    chars = sorted({ch for t in texts for ch in t if ch != " "})
    has_space = any(" " in t for t in texts)
    vocab = ["<blank>", "<unk>"]
    if has_space:
        vocab.append("<space>")
    vocab += chars + ["<sos/eos>"]
    return vocab

def generate_word_vocab(texts, vocab_size=None):
    counter = Counter(w for t in texts for w in t.split())
    words = [w for w, _ in counter.most_common(
        None if vocab_size is None else vocab_size - 3)]
    return ["<blank>", "<unk>"] + words + ["<sos/eos>"]


def main(argv=None):
    p = argparse.ArgumentParser()
    p.add_argument("--text_path", required=True,
                   help="idx2text file (or plain one-sentence-per-line)")
    p.add_argument("--save_path", required=True)
    p.add_argument("--token_type", default="char",
                   choices=["char", "word", "sentencepiece", "subword"])
    p.add_argument("--vocab_size", type=int, default=1000)
    p.add_argument("--model_type", default="bpe",
                   choices=["bpe", "unigram"])
    args = p.parse_args(argv)

    try:
        texts = list(read_idx2data_file(args.text_path).values())
    except Exception:
        with open(args.text_path) as f:
            texts = [line.rstrip("\n") for line in f if line.strip()]

    os.makedirs(args.save_path, exist_ok=True)
    if args.token_type == "char":
        vocab = generate_char_vocab(texts)
    elif args.token_type == "word":
        vocab = generate_word_vocab(texts, args.vocab_size)
    else:
        from speechain_tpu_torch.data.tokenizer import train_subword_tokenizer
        train_subword_tokenizer(texts, args.save_path,
                                vocab_size=args.vocab_size,
                                model_type=args.model_type)
        print(f"wrote subword model + vocab to {args.save_path}")
        return
    with open(os.path.join(args.save_path, "vocab"), "w",
              encoding="utf-8") as f:
        f.write("\n".join(vocab) + "\n")
    print(f"wrote {len(vocab)}-token vocab to {args.save_path}/vocab")


if __name__ == "__main__":
    main()
