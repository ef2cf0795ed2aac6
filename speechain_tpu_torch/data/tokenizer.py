"""A copy of ``speechain_tpu/data/tokenizer.py``.

Tokenizers: char, subword (BPE/unigram), grapheme-to-phoneme.

Rebuild of reference ``speechain/tokenizer/*``:
- vocab file contract (tokenizer/abs.py:17-128): one token per line; special
  tokens ``<blank>`` (pad / CTC blank / ignore), ``<unk>``, ``<sos/eos>``,
  optional ``<space>``; encode attaches <sos/eos> at both ends by default;
  decode drops sos/eos/blank, maps <space> to ' ' and <unk> to '*'.
- CharTokenizer (tokenizer/char.py:12): one token per character.
- SentencePieceTokenizer (tokenizer/sp.py:18): the reference delegates to the
  sentencepiece pip package, which is optional here. The subword path
  here is backed by the HF ``tokenizers`` Rust library (baked in): BPE models
  trained with :func:`train_subword_tokenizer` or loaded from a tokenizer.json.
  A raw sentencepiece ``.model`` protobuf can also be loaded if the
  sentencepiece package happens to be installed (kept optional).
- GraphemeToPhonemeTokenizer (tokenizer/g2p.py:112): the reference uses the
  g2p_en pip package (unavailable); here G2P is lexicon-driven — a
  pronouncing-dictionary file maps words to phoneme strings, OOVs fall back
  to letter-wise phonemes. Recipes provide the lexicon (e.g. from MFA).
"""

from __future__ import annotations

import os
from typing import Dict, List, Optional, Sequence

import numpy as np

from speechain_tpu_torch.utils.registry import register


class Tokenizer:
    """Base tokenizer: vocab handling + decode (tokenizer/abs.py:17)."""

    def __init__(self, token_path: Optional[str] = None,
                 token_vocab: Optional[str] = None, **conf):
        if token_vocab is None:
            assert token_path is not None, "need token_path or token_vocab"
            token_vocab = os.path.join(token_path, "vocab")
        with open(token_vocab, "r", encoding="utf-8") as f:
            tokens = [line.rstrip("\n") for line in f if line.rstrip("\n")]
        self.idx2token: Dict[int, str] = dict(enumerate(tokens))
        self.token2idx: Dict[str, int] = {t: i for i, t in enumerate(tokens)}
        self.vocab_size = len(tokens)
        self.sos_eos_idx = self.token2idx["<sos/eos>"]
        self.ignore_idx = self.token2idx["<blank>"]
        self.unk_idx = self.token2idx["<unk>"]
        self.space_idx = self.token2idx.get("<space>")
        self.tokenizer_init_fn(token_path=token_path, **conf)

    def tokenizer_init_fn(self, token_path=None, **conf):
        pass

    def text2tensor(self, text: str, no_sos: bool = False,
                    no_eos: bool = False) -> np.ndarray:
        raise NotImplementedError

    def tensor2text(self, tensor) -> str:
        """Default decode: join char tokens (tokenizer/abs.py:96-128)."""
        out: List[str] = []
        for idx in np.asarray(tensor).tolist():
            if idx in (self.sos_eos_idx, self.ignore_idx):
                continue
            if self.space_idx is not None and idx == self.space_idx:
                out.append(" ")
            elif idx == self.unk_idx:
                out.append("*")
            else:
                out.append(self.idx2token[idx])
        return "".join(out)


@register("tokenizer.char", "char.CharTokenizer")
class CharTokenizer(Tokenizer):
    """Character tokenizer (tokenizer/char.py:12-48)."""

    def text2tensor(self, text: str, no_sos: bool = False,
                    no_eos: bool = False) -> np.ndarray:
        ids: List[int] = []
        if not no_sos:
            ids.append(self.sos_eos_idx)
        for ch in text:
            if ch == " " and self.space_idx is not None:
                ids.append(self.space_idx)
            else:
                ids.append(self.token2idx.get(ch, self.unk_idx))
        if not no_eos:
            ids.append(self.sos_eos_idx)
        return np.asarray(ids, dtype=np.int32)


@register("tokenizer.subword", "sp.SentencePieceTokenizer", "tokenizer.sentencepiece")
class SubwordTokenizer(Tokenizer):
    """Subword (BPE) tokenizer with sentencepiece-style API (tokenizer/sp.py:18).

    Backends, tried in order:
    1. ``tokenizer.json`` (HF tokenizers) next to the vocab — our native
       format, produced by :func:`train_subword_tokenizer`;
    2. a sentencepiece ``model`` file via the sentencepiece package if it is
       importable (reference-compatible checkpoints).
    """

    def tokenizer_init_fn(self, token_path=None, model_path: Optional[str] = None,
                          **conf):
        self._backend = None
        self._sp = None
        self._sp_native = None
        candidates = []
        if model_path is not None:
            candidates.append(model_path)
        if token_path is not None:
            candidates += [os.path.join(token_path, "tokenizer.json"),
                           os.path.join(token_path, "model")]
        for cand in candidates:
            if not os.path.exists(cand):
                continue
            if cand.endswith(".json"):
                from tokenizers import Tokenizer as HFTokenizer
                self._backend = HFTokenizer.from_file(cand)
                return
            try:
                import sentencepiece as spm
                self._sp = spm.SentencePieceProcessor(model_file=cand)
                return
            except ImportError:
                # reference-compatible fallback: parse the .model protobuf
                # directly (data/sp_model.py)
                from speechain_tpu_torch.data.sp_model import SentencePieceModel
                self._sp_native = SentencePieceModel.load(cand)
                return
        raise FileNotFoundError(
            f"no usable subword model found among {candidates}; train one "
            "with speechain_tpu_torch.data.tokenizer.train_subword_tokenizer")

    def text2tensor(self, text: str, no_sos: bool = False,
                    no_eos: bool = False) -> np.ndarray:
        if self._backend is not None:
            pieces = self._backend.encode(text).tokens
        elif self._sp is not None:
            pieces = self._sp.encode(text, out_type=str)
        else:
            pieces = self._sp_native.encode_pieces(text)
        ids: List[int] = []
        if not no_sos:
            ids.append(self.sos_eos_idx)
        ids.extend(self.token2idx.get(p, self.unk_idx) for p in pieces)
        if not no_eos:
            ids.append(self.sos_eos_idx)
        return np.asarray(ids, dtype=np.int32)

    def tensor2text(self, tensor) -> str:
        pieces = []
        for idx in np.asarray(tensor).tolist():
            if idx in (self.sos_eos_idx, self.ignore_idx):
                continue
            pieces.append("<unk>" if idx == self.unk_idx
                          else self.idx2token[idx])
        # sentencepiece convention: '▁' marks word starts (sp.py decode)
        text = "".join(pieces).replace("▁", " ").strip()
        return text


@register("tokenizer.g2p", "g2p.GraphemeToPhonemeTokenizer")
class GraphemeToPhonemeTokenizer(Tokenizer):
    """Lexicon-driven G2P tokenizer (tokenizer/g2p.py:112).

    ``lexicon_path`` file format: ``word<TAB or space>PH ON EMES`` per line.
    Input text may already be a phoneme list string (list format
    "['AH0', 'B', ...]" like dataset/speech_text.py:322-334) or raw words.
    """

    def tokenizer_init_fn(self, token_path=None, lexicon_path: Optional[str] = None,
                          **conf):
        self.lexicon: Dict[str, List[str]] = {}
        if lexicon_path is None and token_path is not None:
            cand = os.path.join(token_path, "lexicon")
            lexicon_path = cand if os.path.exists(cand) else None
        if lexicon_path is not None:
            with open(lexicon_path, "r", encoding="utf-8") as f:
                for line in f:
                    parts = line.rstrip("\n").replace("\t", " ").split(" ")
                    if len(parts) >= 2:
                        self.lexicon[parts[0].lower()] = [p for p in parts[1:] if p]

    @staticmethod
    def parse_phoneme_list(text: str) -> Optional[List[str]]:
        t = text.strip()
        if t.startswith("[") and t.endswith("]"):
            inner = t[1:-1]
            return [p.strip().strip("'\"") for p in inner.split(",") if p.strip()]
        return None

    def g2p(self, text: str) -> List[str]:
        from speechain_tpu_torch.utils.letter_to_sound import letter_to_sound

        phonemes: List[str] = []
        for w, word in enumerate(text.split()):
            if w > 0:
                phonemes.append("<space>")
            key = word.lower()
            if key in self.lexicon:
                phonemes.extend(self.lexicon[key])
            else:
                # OOV: letter-to-sound rules into the CMU phone inventory
                # (the reference phonemizes OOV words with g2p_en,
                # tokenizer/g2p.py:112 — same role, rule-based here)
                phonemes.extend(letter_to_sound(word))
        return phonemes

    def text2tensor(self, text: str, no_sos: bool = False,
                    no_eos: bool = False) -> np.ndarray:
        plist = self.parse_phoneme_list(text)
        if plist is None:
            plist = self.g2p(text)
        ids: List[int] = []
        if not no_sos:
            ids.append(self.sos_eos_idx)
        for p in plist:
            if p == "<space>" and self.space_idx is not None:
                ids.append(self.space_idx)
            elif p in self.token2idx:
                ids.append(self.token2idx[p])
            elif p and p[-1].isdigit() and p[:-1] in self.token2idx:
                # stress-stripped fallback for unstressed vocabularies
                ids.append(self.token2idx[p[:-1]])
            else:
                ids.append(self.unk_idx)
        if not no_eos:
            ids.append(self.sos_eos_idx)
        return np.asarray(ids, dtype=np.int32)

    def tensor2text(self, tensor) -> str:
        """Phonemes are space-joined; the <space> token stays literal so the
        word structure is preserved in reports."""
        out = []
        for idx in np.asarray(tensor).tolist():
            if idx in (self.sos_eos_idx, self.ignore_idx):
                continue
            out.append("*" if idx == self.unk_idx else self.idx2token[idx])
        return " ".join(out)


def train_subword_tokenizer(text_iter: Sequence[str], save_dir: str,
                            vocab_size: int = 1000,
                            model_type: str = "bpe") -> str:
    """Train a subword model + write the reference-format ``vocab`` file.

    Vocab layout follows the reference's sentencepiece convention
    (datasets/pyscripts/vocab_generator.py): index 0 = <blank>, 1 = <unk>,
    last = <sos/eos>; pieces in between.
    Returns the directory containing ``tokenizer.json`` + ``vocab``.
    """
    from tokenizers import Tokenizer as HFTokenizer
    from tokenizers.models import BPE, Unigram
    from tokenizers.pre_tokenizers import Metaspace
    from tokenizers.trainers import BpeTrainer, UnigramTrainer

    os.makedirs(save_dir, exist_ok=True)
    n_pieces = vocab_size - 3
    if model_type == "bpe":
        tok = HFTokenizer(BPE(unk_token="<unk>"))
        trainer = BpeTrainer(vocab_size=n_pieces + 1,  # +1 for <unk>
                             special_tokens=["<unk>"])
    elif model_type == "unigram":
        tok = HFTokenizer(Unigram())
        trainer = UnigramTrainer(vocab_size=n_pieces + 1, unk_token="<unk>",
                                 special_tokens=["<unk>"])
    else:
        raise ValueError(model_type)
    tok.pre_tokenizer = Metaspace()
    tok.train_from_iterator(text_iter, trainer)
    tok.save(os.path.join(save_dir, "tokenizer.json"))

    pieces = [p for p, _ in sorted(tok.get_vocab().items(),
                                   key=lambda kv: kv[1]) if p != "<unk>"]
    vocab = ["<blank>", "<unk>"] + pieces + ["<sos/eos>"]
    with open(os.path.join(save_dir, "vocab"), "w", encoding="utf-8") as f:
        f.write("\n".join(vocab) + "\n")
    return save_dir
