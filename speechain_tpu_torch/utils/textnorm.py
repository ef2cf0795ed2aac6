"""A copy of ``speechain_tpu/utils/textnorm.py``.

English text normalization profiles (``txt_format``).

Behavioral rebuild of reference ``utilbox/dump_util.py:10-160``
(en_text_process): the exact rule set must be reproduced because vocabularies
and WER numbers depend on it (SURVEY §2.8). Profiles:

- 'punc':    lowercase letters + the marks , . ' ! ? (TTS recipes);
- 'no-punc': lowercase letters + intra-word single quotes (ASR recipes).

Rule pipeline (same order as the reference):
1. lowercase;
2. accented-letter folding (è é ê → e, â à → a, ü → u, ñ → n, ô → o,
   æ → ae, œ → oe);
3. all quote variants → ASCII single quote, doubled quotes collapsed;
4. colons: ":'" → "," then ":" → ","; semicolons → ".";
5. dashes: "--", em-dash, macron → "-", then "-" → ","; "/" → ".";
6. every non-letter except , . ' ! ? → space;
7. context-dependent apostrophes: keep only intra-word ones; a quote with a
   letter left and space right → comma; between two punctuation marks →
   space; otherwise dropped;
8. duplicated terminal punctuation collapsed to the last mark; leading
   blanks/punctuation stripped; spacing normalized (no blank before a mark,
   one blank after a mark that precedes a letter, consecutive marks keep the
   last).
"""

from __future__ import annotations

import re

_ACCENTS = {"è": "e", "é": "e", "ê": "e", "â": "a", "à": "a", "ü": "u",
            "ñ": "n", "ô": "o", "æ": "ae", "œ": "oe"}
_QUOTES = ["’", "‘", "“", "”", '"']
_KEEP_MARKS = (",", ".", "'", "!", "?")


def _is_punc(ch: str) -> bool:
    return not (ch.isalpha() or ch == " ")


def en_text_process(input_text: str, txt_format: str) -> str:
    text = input_text.lower()
    for src, dst in _ACCENTS.items():
        text = text.replace(src, dst)
    for q in _QUOTES:
        text = text.replace(q, "'")
    text = text.replace("''", "'")
    text = text.replace(":'", ",").replace(":", ",").replace(";", ".")
    text = (text.replace("--", "-").replace("—", "-").replace("¯", "-")
            .replace("-", ",").replace("/", "."))

    # non-letters outside the kept marks become spaces
    text = "".join(ch if ch.isalpha() or ch in _KEEP_MARKS else " "
                   for ch in text)

    # context-dependent apostrophes
    kept = []
    for i, ch in enumerate(text):
        if ch != "'":
            kept.append(ch)
        elif i == 0 or i == len(text) - 1:
            continue
        elif not text[i - 1].isalpha() or not text[i + 1].isalpha():
            if text[i - 1].isalpha() and text[i + 1] == " ":
                kept.append(",")
            elif _is_punc(text[i - 1]) and _is_punc(text[i + 1]):
                kept.append(" ")
        else:
            kept.append(ch)
    text = "".join(kept)

    # duplicated terminal punctuation -> keep the last mark
    text = re.sub(r"([.,!?]\s*)+!", "!", text)
    text = re.sub(r"([.,!?]\s*)+\?", "?", text)
    text = re.sub(r"([.,!?]\s*)+\.", ".", text)
    text = re.sub(r"([.,!?]\s*)+,", ",", text)

    # strip leading blanks/punctuation and trailing blanks
    while text and (text.startswith(" ") or _is_punc(text[0])):
        text = text[1:]
    while text.endswith(" "):
        text = text[:-1]

    # spacing normalization
    out = []
    for i, ch in enumerate(text):
        if ch == " ":
            if i + 1 < len(text) and text[i + 1] == " ":
                continue
            if out and out[-1].isalpha() and i + 1 < len(text) \
                    and _is_punc(text[i + 1]):
                continue
        elif _is_punc(ch) and ch != "'" and i < len(text) - 1:
            if text[i + 1].isalpha():
                out.append(ch + " ")
                continue
            if _is_punc(text[i + 1]):
                continue
        out.append(ch)
    text = "".join(out)

    if txt_format == "punc":
        return text
    if txt_format == "no-punc":
        return "".join(ch for ch in text
                       if ch.isalpha() or ch in ("'", " "))
    raise ValueError(f"txt_format must be 'punc' or 'no-punc', "
                     f"got {txt_format!r}")
