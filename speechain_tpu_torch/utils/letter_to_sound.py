"""A copy of ``speechain_tpu/utils/letter_to_sound.py``.

English letter-to-sound rules producing ARPAbet (CMU) phones.

OOV fallback for the G2P tokenizer (reference: tokenizer/g2p.py:112 uses the
g2p_en neural model for out-of-lexicon words; that package is not available
here, so OOV words are phonemized with context-sensitive letter-to-sound
rules in the style of the public-domain NRL rule set, Elovitz et al. 1976,
"Automatic Translation of English Text to Phonetics"). Output phones are
restricted to the CMU inventory the reference enumerates at
tokenizer/g2p.py:9-23; vowels carry a stress digit (primary stress on the
first vowel, 0 elsewhere — a deterministic stand-in for g2p_en's predicted
stress).

Rule notation (NRL):
  ``#`` one or more vowels        ``:`` zero or more consonants
  ``^`` exactly one consonant     ``.`` one voiced consonant (bdvgjlmnrwz)
  ``+`` one front vowel (e i y)   ``%`` suffix (e|er|es|ed|ing|ely)
  `` `` word boundary
Rules are tried in order per letter; the first whose fragment and contexts
match wins, and the cursor advances past the fragment.
"""

from __future__ import annotations

from typing import List, Optional, Tuple

VOWELS = set("aeiouy")
CONSONANTS = set("bcdfghjklmnpqrstvwxz")
VOICED = set("bdvgjlmnrwz")
FRONT = set("eiy")

# The CMU phone inventory (reference tokenizer/g2p.py:9-23). Vowel phones
# take a stress digit when emitted.
CMU_VOWELS = {"AA", "AE", "AH", "AO", "AW", "AY", "EH", "ER", "EY", "IH",
              "IY", "OW", "OY", "UH", "UW"}
CMU_CONSONANTS = {"B", "CH", "D", "DH", "F", "G", "HH", "JH", "K", "L", "M",
                  "N", "NG", "P", "R", "S", "SH", "T", "TH", "V", "W", "Y",
                  "Z", "ZH"}

# (fragment, left-context, right-context, phones) — ordered, per first letter.
# Contexts are NRL patterns matched against the letters adjacent to the
# fragment. "" matches anything.
R = lambda frag, left, right, phones: (frag, left, right, phones.split())

RULES = {
    "a": [
        R("age", "#:", " ", "AH JH"),     # village language message
        R("arr", "", "", "AE R"),         # carry arrow (rr sounds once)
        R("ar", " ", "#", "AH R"),        # around arise
        R("ar", "", " ", "AA R"),
        R("ar", "", "", "AA R"),
        R("air", "", "", "EH R"),
        R("ai", "", "", "EY"),
        R("ay", "", "", "EY"),
        R("au", "", "", "AO"),
        R("aw", "", "", "AO"),
        R("al", "", "^", "AO L"),
        R("able", "", "", "AH B AH L"),
        R("ange", "", "", "EY N JH"),
        R("a", "", "^e ", "EY"),          # magic e: a<cons>e#
        R("a", "", "^%", "EY"),
        R("a", " ", "^^", "AE"),          # answer after ask (cluster)
        R("a", " ", "", "AH"),
        R("a", "", "", "AE"),
    ],
    "b": [
        R("b", "", "", "B"),
    ],
    "c": [
        R("cean", "", " ", "SH AH N"),    # ocean
        R("chine", "", " ", "SH IY N"),   # machine
        R("ch", "", "", "CH"),
        R("ci", "", "#", "SH"),           # -cious, -cial
        R("c", "", "+", "S"),             # ce ci cy
        R("ck", "", "", "K"),
        R("c", "", "", "K"),
    ],
    "d": [
        R("dge", "", "", "JH"),
        R("d", "", "", "D"),
    ],
    "e": [
        R("ear", "", "^", "ER"),          # earth early learn heard
        R("ear", "", "", "IY R"),         # ear hear appear
        R("eo", "", "", "IY"),            # people
        R("ee", "", "", "IY"),
        R("ea", "", "", "IY"),
        R("ew", "", "", "UW"),
        R("er", "", "", "ER"),
        R("eign", "", "", "EY N"),        # reign foreign
        R("eigh", "", "", "EY"),
        R("ey", "", " ", "IY"),
        R("e", "", " ", ""),              # final silent e
        R("ed", "", " ", "D"),            # past-tense suffix
        R("e", "", "^e ", "IY"),
        R("e", "", "", "EH"),
    ],
    "f": [
        R("f", "", "", "F"),
    ],
    "g": [
        R("gu", "n", "#", "G W"),         # language anguish
        R("gh", "", "", "G"),             # word-initial-ish gh ('ghost')
        R("gn", " ", "", "N"),
        R("g", "", "+", "JH"),            # ge gi gy
        R("g", "", "", "G"),
    ],
    "h": [
        R("h", "", "#", "HH"),
        R("h", "", "", ""),               # silent h
    ],
    "i": [
        R("isl", "", "", "AY L"),         # island isle (silent s)
        R("igh", "", "", "AY"),
        R("ind", "", " ", "AY N D"),
        R("ir", "", "", "ER"),
        R("ie", "", " ", "AY"),
        R("ious", "", "", "IY AH S"),
        R("ie", "", "^", "IY"),           # believe field
        R("i", "", "e", "AY"),            # hiatus: quiet diet
        R("ion", "", " ", "AH N"),
        R("i", "", "^e ", "AY"),          # magic e
        R("i", "", "^%", "AY"),
        R("ing", "", " ", "IH NG"),
        R("i", "", "", "IH"),
    ],
    "j": [
        R("j", "", "", "JH"),
    ],
    "k": [
        R("kn", " ", "", "N"),            # silent k word-initially
        R("k", "", "", "K"),
    ],
    "l": [
        R("le", "^", " ", "AH L"),
        R("l", "", "", "L"),
    ],
    "m": [
        R("m", "", "", "M"),
    ],
    "n": [
        R("ng", "", "", "NG"),
        R("n", "", "", "N"),
    ],
    "o": [
        R("other", "", "", "AH DH ER"),   # mother brother another
        R("othing", "", "", "AH TH IH NG"),
        R("orr", "", "", "AA R"),        # tomorrow sorrow borrow
        R("ought", "", "", "AO T"),       # thought bought ought
        R("ough", "thr", "", "UW"),       # through
        R("ough", "th", "", "OW"),        # though although
        R("ough", "", " ", "AH F"),       # enough rough tough
        R("o", "", "cean ", "OW"),        # ocean
        R("or", "", "", "AO R"),
        R("oo", "", "", "UW"),
        R("ou", "", "", "AW"),
        R("ow", "", " ", "OW"),
        R("ow", "", "", "AW"),
        R("oi", "", "", "OY"),
        R("oy", "", "", "OY"),
        R("oa", "", "", "OW"),
        R("old", "", "", "OW L D"),
        R("o", "", "^e ", "OW"),          # magic e
        R("o", "", "^%", "OW"),
        R("o", "", " ", "OW"),
        R("o", "", "", "AA"),
    ],
    "p": [
        R("ph", "", "", "F"),
        R("p", "", "", "P"),
    ],
    "q": [
        R("qu", "", "", "K W"),
        R("q", "", "", "K"),
    ],
    "r": [
        R("r", "", "", "R"),
    ],
    "s": [
        R("sh", "", "", "SH"),
        R("sion", "#", "", "ZH AH N"),
        R("sion", "", "", "SH AH N"),
        R("s", "#", " ", "Z"),            # plural after vowel
        R("s", ".", " ", "Z"),            # plural after voiced consonant
        R("s", "#", "#", "Z"),            # intervocalic s: reason easy
        R("ss", "", "", "S"),
        R("s", "", "", "S"),
    ],
    "t": [
        R("tion", "", "", "SH AH N"),
        R("ture", "", " ", "CH ER"),      # nature picture future
        R("th", " ", "", "TH"),
        R("th", "", " ", "TH"),
        R("th", "", "", "DH"),
        R("t", "", "", "T"),
    ],
    "u": [
        R("ur", "", "", "ER"),
        R("u", "", "^e ", "UW"),          # magic e
        R("u", "", "^%", "UW"),
        R("u", " ", "^#", "Y UW"),        # unit use; NOT under/until
        R("u", "", "", "AH"),
    ],
    "v": [
        R("v", "", "", "V"),
    ],
    "w": [
        R("wh", "", "", "W"),
        R("wr", " ", "", "R"),
        R("w", "", "", "W"),
    ],
    "x": [
        R("x", " ", "", "Z"),             # xylophone
        R("x", "", "", "K S"),
    ],
    "y": [
        R("y", " ", "", "Y"),             # consonantal word-initial y
        R("y", "", " ", "IY"),
        R("y", "^", "^", "IH"),
        R("y", "", "", "IY"),
    ],
    "z": [
        R("zz", "", "", "Z"),
        R("z", "", "", "Z"),
    ],
}


def _match_left(pattern: str, word: str, pos: int) -> bool:
    """Match an NRL left-context pattern ending at ``pos`` (exclusive)."""
    i = pos
    for ch in reversed(pattern):
        if ch == " ":
            return i == 0
        if i <= 0:
            return False
        c = word[i - 1]
        if ch == "#":
            if c not in VOWELS:
                return False
            i -= 1
            while i > 0 and word[i - 1] in VOWELS:
                i -= 1
        elif ch == ":":
            while i > 0 and word[i - 1] in CONSONANTS:
                i -= 1
        elif ch == "^":
            if c not in CONSONANTS:
                return False
            i -= 1
        elif ch == ".":
            if c not in VOICED:
                return False
            i -= 1
        elif ch == "+":
            if c not in FRONT:
                return False
            i -= 1
        else:
            if c != ch:
                return False
            i -= 1
    return True


def _match_right(pattern: str, word: str, pos: int) -> bool:
    """Match an NRL right-context pattern starting at ``pos``."""
    i = pos
    n = len(word)
    for ch in pattern:
        if ch == " ":
            return i >= n
        if ch == "%":
            rest = word[i:]
            return any(rest.startswith(s) and len(rest) == len(s)
                       for s in ("e", "er", "es", "ed", "ing", "ely"))
        if i >= n:
            return False
        c = word[i]
        if ch == "#":
            if c not in VOWELS:
                return False
            i += 1
            while i < n and word[i] in VOWELS:
                i += 1
        elif ch == ":":
            while i < n and word[i] in CONSONANTS:
                i += 1
        elif ch == "^":
            if c not in CONSONANTS:
                return False
            i += 1
        elif ch == ".":
            if c not in VOICED:
                return False
            i += 1
        elif ch == "+":
            if c not in FRONT:
                return False
            i += 1
        else:
            if c != ch:
                return False
            i += 1
    return True


# per-letter last-resort phones (always fire)
DEFAULTS = {
    "a": "AE", "b": "B", "c": "K", "d": "D", "e": "EH", "f": "F", "g": "G",
    "h": "HH", "i": "IH", "j": "JH", "k": "K", "l": "L", "m": "M", "n": "N",
    "o": "AA", "p": "P", "q": "K", "r": "R", "s": "S", "t": "T", "u": "AH",
    "v": "V", "w": "W", "x": "K S", "y": "IY", "z": "Z",
}


def letter_to_sound(word: str, stress_first: bool = True) -> List[str]:
    """Phonemize one word with the rule set; returns CMU phones with stress
    digits on vowels. Non-alphabetic characters are dropped."""
    w = "".join(c for c in word.lower() if c.isalpha())
    phones: List[str] = []
    pos = 0
    while pos < len(w):
        letter = w[pos]
        emitted: Optional[List[str]] = None
        consumed = 1
        for frag, left, right, ph in RULES.get(letter, []):
            if not w.startswith(frag, pos):
                continue
            if left and not _match_left(left, w, pos):
                continue
            if right and not _match_right(right, w, pos + len(frag)):
                continue
            emitted = ph
            consumed = len(frag)
            break
        if emitted is None:
            emitted = DEFAULTS.get(letter, "").split()
        pos += consumed
        # doubled consonant letters sound once (ll, tt, ss, ...)
        if (consumed == 1 and letter in CONSONANTS
                and pos < len(w) and w[pos] == letter):
            pos += 1
        phones.extend(emitted)
    # stress digits: primary stress on the first vowel, 0 elsewhere
    out: List[str] = []
    stressed = not stress_first
    for p in phones:
        if p in CMU_VOWELS:
            out.append(p + ("1" if not stressed else "0"))
            stressed = True
        else:
            out.append(p)
    return out
