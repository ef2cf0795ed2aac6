"""A copy of ``speechain_tpu/data/sp_model.py``.

Minimal SentencePiece ``.model`` reader + encoder.

Reference recipes carry sentencepiece model files (tokenizer/sp.py:18); the
sentencepiece pip package is not a dependency, so this module parses the
ModelProto protobuf wire format directly (pieces + scores + model type) and
implements the two inference algorithms:

- unigram: Viterbi segmentation maximizing the sum of piece log-probs;
- BPE: iterative lowest-rank merges (score = -merge_rank in SP BPE models).

Text is pre-normalized the SP way for the common case: whitespace ->
'▁' word markers with a leading marker. NFKC normalization and user-defined
symbols beyond the standard control pieces are not implemented (the
reference recipes train with defaults).
"""

from __future__ import annotations

from typing import Dict, List, Optional, Tuple

WORD_MARK = "▁"  # '▁'


def _read_varint(buf: bytes, pos: int) -> Tuple[int, int]:
    shift = 0
    val = 0
    while True:
        b = buf[pos]
        pos += 1
        val |= (b & 0x7F) << shift
        if not b & 0x80:
            return val, pos
        shift += 7


def _iter_fields(buf: bytes):
    pos = 0
    n = len(buf)
    while pos < n:
        key, pos = _read_varint(buf, pos)
        field, wire = key >> 3, key & 7
        if wire == 0:            # varint
            val, pos = _read_varint(buf, pos)
        elif wire == 1:          # 64-bit
            val, pos = buf[pos:pos + 8], pos + 8
        elif wire == 2:          # length-delimited
            ln, pos = _read_varint(buf, pos)
            val, pos = buf[pos:pos + ln], pos + ln
        elif wire == 5:          # 32-bit
            val, pos = buf[pos:pos + 4], pos + 4
        else:
            raise ValueError(f"unsupported wire type {wire}")
        yield field, wire, val


class SentencePieceModel:
    """Parsed model: pieces, scores, types, model_type ('unigram'|'bpe')."""

    NORMAL, UNKNOWN, CONTROL, USER_DEFINED, BYTE, UNUSED = 1, 2, 3, 4, 6, 5

    def __init__(self, model_bytes: bytes):
        import struct

        self.pieces: List[str] = []
        self.scores: List[float] = []
        self.types: List[int] = []
        model_type = 1
        for field, wire, val in _iter_fields(model_bytes):
            if field == 1 and wire == 2:          # repeated SentencePiece
                piece, score, ptype = "", 0.0, self.NORMAL
                for f2, w2, v2 in _iter_fields(val):
                    if f2 == 1:
                        piece = v2.decode("utf-8")
                    elif f2 == 2:
                        score = struct.unpack("<f", v2)[0]
                    elif f2 == 3:
                        ptype = v2
                self.pieces.append(piece)
                self.scores.append(score)
                self.types.append(ptype)
            elif field == 2 and wire == 2:        # TrainerSpec
                for f2, w2, v2 in _iter_fields(val):
                    if f2 == 3 and w2 == 0:       # model_type enum
                        model_type = v2
        self.model_type = {1: "unigram", 2: "bpe", 3: "word",
                           4: "char"}.get(model_type, "unigram")
        self.piece2id: Dict[str, int] = {p: i for i, p in
                                         enumerate(self.pieces)}
        self.max_piece_len = max((len(p) for p in self.pieces), default=1)
        unk_candidates = [i for i, t in enumerate(self.types)
                          if t == self.UNKNOWN]
        self.unk_id = unk_candidates[0] if unk_candidates else 0

    @classmethod
    def load(cls, path: str) -> "SentencePieceModel":
        with open(path, "rb") as f:
            return cls(f.read())

    # ------------------------------------------------------------------
    def _pretokenize(self, text: str) -> str:
        text = " ".join(text.split())
        return WORD_MARK + text.replace(" ", WORD_MARK)

    def encode_pieces(self, text: str) -> List[str]:
        s = self._pretokenize(text)
        if self.model_type == "bpe":
            return self._encode_bpe(s)
        return self._encode_unigram(s)

    def encode_ids(self, text: str) -> List[int]:
        return [self.piece2id.get(p, self.unk_id)
                for p in self.encode_pieces(text)]

    def _encode_unigram(self, s: str) -> List[str]:
        """Viterbi over piece log-probs; unknown chars get a large penalty."""
        n = len(s)
        NEG = -1e18
        best = [NEG] * (n + 1)
        back: List[Optional[Tuple[int, str]]] = [None] * (n + 1)
        best[0] = 0.0
        for i in range(n):
            if best[i] <= NEG / 2:
                continue
            upper = min(n, i + self.max_piece_len)
            for j in range(i + 1, upper + 1):
                piece = s[i:j]
                pid = self.piece2id.get(piece)
                if pid is not None and self.types[pid] in (
                        self.NORMAL, self.USER_DEFINED):
                    sc = best[i] + self.scores[pid]
                    if sc > best[j]:
                        best[j] = sc
                        back[j] = (i, piece)
            # unknown fallback: single char
            if back[i + 1] is None or best[i] - 20.0 > best[i + 1]:
                sc = best[i] - 20.0
                if sc > best[i + 1]:
                    best[i + 1] = sc
                    back[i + 1] = (i, s[i:i + 1])
        out: List[str] = []
        j = n
        while j > 0:
            i, piece = back[j]
            out.append(piece)
            j = i
        out.reverse()
        return out

    def _encode_bpe(self, s: str) -> List[str]:
        """Greedy lowest-rank merges (SP BPE stores score = -rank)."""
        symbols = list(s)
        while True:
            best_score, best_i = None, -1
            for i in range(len(symbols) - 1):
                cand = symbols[i] + symbols[i + 1]
                pid = self.piece2id.get(cand)
                if pid is None:
                    continue
                sc = self.scores[pid]
                if best_score is None or sc > best_score:
                    best_score, best_i = sc, i
            if best_i < 0:
                return symbols
            symbols[best_i:best_i + 2] = [symbols[best_i]
                                          + symbols[best_i + 1]]

    def decode_pieces(self, pieces: List[str]) -> str:
        return "".join(pieces).replace(WORD_MARK, " ").strip()
