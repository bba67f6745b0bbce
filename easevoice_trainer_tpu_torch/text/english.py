"""English G2P: text normalization + CMUdict lookup + OOV strategies.

Behavior modeled on the reference English frontend
(reference: src/easevoice/text/english.py:125-289): normalize punctuation
and numbers, strip accents, tokenize, then per word: CMUdict first
pronunciation; single letters spell out ("A" -> EY1); short OOVs spell
letter-by-letter; possessive 's attaches by final-phoneme voicing; longer
OOVs try greedy compound segmentation against the dictionary, then a
letter-to-sound fallback (the reference uses the g2p_en neural model there).
"""
from __future__ import annotations

import gzip
import json
import os
import re
import unicodedata
from functools import lru_cache
from typing import Dict, List

from .symbols import SYMBOLS, PUNCTUATION

_DATA = os.path.join(os.path.dirname(__file__), "data", "cmudict.json.gz")


@lru_cache(maxsize=1)
def cmudict() -> Dict[str, List[str]]:
    with gzip.open(_DATA, "rt", encoding="utf8") as f:
        d = json.load(f)
    # lowercase keys for lookup; keep first pronunciation only (already so)
    return {k.lower(): v for k, v in d.items()}


# ---------------------------------------------------------------------------
# number expansion (stand-in for the reference's inflect-based normalize)
# ---------------------------------------------------------------------------

_ONES = ["zero", "one", "two", "three", "four", "five", "six", "seven",
         "eight", "nine", "ten", "eleven", "twelve", "thirteen", "fourteen",
         "fifteen", "sixteen", "seventeen", "eighteen", "nineteen"]
_TENS = ["", "", "twenty", "thirty", "forty", "fifty", "sixty", "seventy",
         "eighty", "ninety"]
_SCALES = [(10 ** 9, "billion"), (10 ** 6, "million"), (10 ** 3, "thousand"),
           (100, "hundred")]


def number_to_words(n: int) -> str:
    if n < 0:
        return "minus " + number_to_words(-n)
    if n < 20:
        return _ONES[n]
    if n < 100:
        tens, rem = divmod(n, 10)
        return _TENS[tens] + (" " + _ONES[rem] if rem else "")
    for value, name in _SCALES:
        if n >= value:
            major, rem = divmod(n, value)
            out = number_to_words(major) + " " + name
            if rem:
                out += " " + number_to_words(rem)
            return out
    return _ONES[0]


def _expand_decimal(m: re.Match) -> str:
    whole, frac = m.group(1), m.group(2)
    out = number_to_words(int(whole)) + " point"
    for digit in frac:
        out += " " + _ONES[int(digit)]
    return out


def _expand_dollars(m: re.Match) -> str:
    value = m.group(1).replace(",", "")
    if "." in value:
        d, c = value.split(".")
        parts = []
        if int(d or 0):
            parts.append(number_to_words(int(d))
                         + (" dollar" if int(d) == 1 else " dollars"))
        if int(c or 0):
            parts.append(number_to_words(int(c))
                         + (" cent" if int(c) == 1 else " cents"))
        return " ".join(parts) or "zero dollars"
    n = int(value)
    return number_to_words(n) + (" dollar" if n == 1 else " dollars")


_ORDINAL_SUFFIX = {"one": "first", "two": "second", "three": "third",
                   "five": "fifth", "eight": "eighth", "nine": "ninth",
                   "twelve": "twelfth"}


def _ordinal_words(n: int) -> str:
    words = number_to_words(n)
    head, _, last = words.rpartition(" ")
    if last in _ORDINAL_SUFFIX:
        last = _ORDINAL_SUFFIX[last]
    elif last.endswith("y"):
        last = last[:-1] + "ieth"
    else:
        last = last + "th"
    return (head + " " + last).strip()


def normalize_numbers(text: str) -> str:
    text = re.sub(r"\$([0-9.,]*[0-9])", _expand_dollars, text)
    text = re.sub(r"([0-9]+)\.([0-9]+)", _expand_decimal, text)
    text = re.sub(r"([0-9]+)(st|nd|rd|th)",
                  lambda m: _ordinal_words(int(m.group(1))), text)
    text = re.sub(r"[0-9,]*[0-9]",
                  lambda m: number_to_words(int(m.group(0).replace(",", ""))),
                  text)
    return text


def text_normalize(text: str) -> str:
    rep_map = {"[;:：，；]": ",", '["’]': "'", "。": ".", "！": "!", "？": "?"}
    for pat, r in rep_map.items():
        text = re.sub(pat, r, text)
    text = normalize_numbers(text)
    text = "".join(ch for ch in unicodedata.normalize("NFD", text)
                   if unicodedata.category(ch) != "Mn")
    text = re.sub(r"[^ A-Za-z'.,?!\-]", "", text)
    text = re.sub(r"(?i)i\.e\.", "that is", text)
    text = re.sub(r"(?i)e\.g\.", "for example", text)
    punct = "".join(re.escape(p) for p in PUNCTUATION)
    text = re.sub(f"([{punct}])([{punct}])+", r"\1", text)
    return text


# ---------------------------------------------------------------------------
# grapheme -> phoneme
# ---------------------------------------------------------------------------

_VOICELESS_END = {"P", "T", "K", "F", "TH", "HH"}
_SIBILANT_END = {"S", "Z", "SH", "ZH", "CH", "JH"}

# minimal letter-to-sound fallback (reference delegates to the g2p_en
# neural model here); digraph-first greedy rules
_LTS = [
    ("tion", ["SH", "AH0", "N"]), ("ough", ["AO1"]), ("igh", ["AY1"]),
    ("ch", ["CH"]), ("sh", ["SH"]), ("th", ["TH"]), ("ph", ["F"]),
    ("wh", ["W"]), ("ck", ["K"]), ("ng", ["NG"]), ("qu", ["K", "W"]),
    ("ee", ["IY1"]), ("oo", ["UW1"]), ("ou", ["AW1"]), ("ai", ["EY1"]),
    ("ay", ["EY1"]), ("oa", ["OW1"]), ("ea", ["IY1"]),
    ("a", ["AE1"]), ("b", ["B"]), ("c", ["K"]), ("d", ["D"]), ("e", ["EH1"]),
    ("f", ["F"]), ("g", ["G"]), ("h", ["HH"]), ("i", ["IH1"]), ("j", ["JH"]),
    ("k", ["K"]), ("l", ["L"]), ("m", ["M"]), ("n", ["N"]), ("o", ["AA1"]),
    ("p", ["P"]), ("r", ["R"]), ("s", ["S"]), ("t", ["T"]), ("u", ["AH1"]),
    ("v", ["V"]), ("w", ["W"]), ("x", ["K", "S"]), ("y", ["Y"]),
    ("z", ["Z"]), ("'", []),
]


def letter_to_sound(word: str) -> List[str]:
    phones: List[str] = []
    i = 0
    while i < len(word):
        for pat, ph in _LTS:
            if word.startswith(pat, i):
                phones += ph
                i += len(pat)
                break
        else:
            i += 1
    return phones


@lru_cache(maxsize=4096)
def _segment(word: str) -> tuple:
    """Greedy longest-prefix dictionary segmentation for compounds."""
    d = cmudict()
    parts = []
    i = 0
    n = len(word)
    while i < n:
        for j in range(n, i + 2, -1):
            if word[i:j] in d:
                parts.append(word[i:j])
                i = j
                break
        else:
            return (word,)  # unsegmentable
    return tuple(parts) if len(parts) > 1 else (word,)


def _spell(word: str) -> List[str]:
    d = cmudict()
    phones: List[str] = []
    for ch in word:
        if ch == "a":
            phones += ["EY1"]
        elif not ch.isalpha():
            phones.append(ch)
        elif ch in d:
            phones += d[ch]
    return phones


def query_word(o_word: str) -> List[str]:
    d = cmudict()
    word = o_word.lower()
    if len(word) > 1 and word in d:
        return list(d[word])
    if len(word) <= 3:
        return _spell(word)
    m = re.match(r"^([a-z]+)('s)$", word)
    if m:
        phones = list(query_word(m.group(1)))
        if phones and phones[-1] in _VOICELESS_END:
            phones.append("S")
        elif phones and phones[-1] in _SIBILANT_END:
            phones += ["AH0", "Z"]
        else:
            phones.append("Z")
        return phones
    comps = _segment(word)
    if len(comps) > 1:
        return [p for c in comps for p in query_word(c)]
    return letter_to_sound(word)


_TOKEN_RE = re.compile(r"[A-Za-z]+(?:'[A-Za-z]+)?|[^\sA-Za-z]")


def g2p(text: str) -> List[str]:
    phones: List[str] = []
    for o_word in _TOKEN_RE.findall(text):
        word = o_word.lower()
        if re.search("[a-z]", word) is None:
            phones.append(word)
        elif len(word) == 1:
            phones += ["EY1"] if o_word == "A" else list(cmudict().get(word, []))
        else:
            phones += query_word(o_word)
    # keep inventory symbols; map apostrophe; drop anything unknown
    out = []
    for ph in phones:
        if ph in SYMBOLS:
            out.append(ph)
        elif ph == "'":
            out.append("-")
    return out
