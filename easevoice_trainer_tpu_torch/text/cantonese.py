"""Cantonese G2P (jyutping -> Y-prefixed symbols).

Reference pipeline (src/easevoice/text/cantonese.py:11-195): zh text
normalization (incl. trad->simp), punctuation fold, pyjyutping char->
jyutping, then the reference's exact initial/final/tone split over its
quirky INITIALS list with a Y-prefix inventory.

Backends for the char->jyutping step, in order: ``ToJyutping`` /
``pyjyutping`` when importable (the reference hard-depends on the
latter), else a vendored curated table
(``data/jyutping_table.json``, ~840 high-frequency chars + word
overrides, expanded across the vendored trad<->simp mapping).  Unknown
hanzi are dropped from the phone stream, mirroring the reference's
behavior for unmatched syllables.
"""
from __future__ import annotations

import json
import os
import re
from functools import lru_cache
from typing import List, Optional, Tuple

from .symbols import PUNCTUATION, PUNCTUATION_SET
from .chinese_norm import TextNormalizer

_NORMALIZER = TextNormalizer()

# reference cantonese.py:16-60 — order matters (first prefix match wins)
INITIALS = [
    "aa", "aai", "aak", "aap", "aat", "aau", "ai", "au", "ap", "at", "ak",
    "a", "p", "b", "e", "ts", "t", "dz", "d", "kw", "k", "gw", "g", "f",
    "h", "l", "m", "ng", "n", "s", "y", "w", "c", "z", "j", "ong", "on",
    "ou", "oi", "ok", "o", "uk", "ung", "sp", "spl", "spn", "sil",
]

REP_MAP = {
    "：": ",", "；": ",", "，": ",", "。": ".", "！": "!", "？": "?",
    "\n": ".", "·": ",", "、": ",", "...": "…", "$": ".", "“": "'",
    "”": "'", '"': "'", "‘": "'", "’": "'", "（": "'", "）": "'",
    "(": "'", ")": "'", "《": "'", "》": "'", "【": "'", "】": "'",
    "[": "'", "]": "'", "—": "-", "～": "-", "~": "-", "「": "'",
    "」": "'",
}


def replace_punctuation(text: str) -> str:
    pattern = re.compile("|".join(re.escape(p) for p in REP_MAP))
    text = pattern.sub(lambda x: REP_MAP[x.group()], text)
    return re.sub(r"[^一-龥" + "".join(PUNCTUATION) + r"]+", "",
                  text)


def text_normalize(text: str) -> str:
    out = ""
    for sentence in _NORMALIZER.normalize(text):
        out += replace_punctuation(sentence)
    return out


# ---------------------------------------------------------------------------
# char -> jyutping backends
# ---------------------------------------------------------------------------


@lru_cache(maxsize=1)
def _vendored_table() -> Tuple[dict, dict]:
    here = os.path.dirname(os.path.abspath(__file__))
    with open(os.path.join(here, "data", "jyutping_table.json"),
              encoding="utf-8") as fp:
        data = json.load(fp)
    chars = dict(data["chars"])
    words = {w: list(s) for w, s in data["words"].items()}
    # expand across the trad<->simp mapping so either script resolves
    try:
        with open(os.path.join(here, "data", "trad2simp.json"),
                  encoding="utf-8") as fp:
            t2s = json.load(fp)
    except OSError:
        t2s = {}
    for trad, simp in t2s.items():
        if trad in chars and simp not in chars:
            chars[simp] = chars[trad]
        elif simp in chars and trad not in chars:
            chars[trad] = chars[simp]
    for word in list(words):
        alt = "".join(t2s.get(ch, ch) for ch in word)
        if alt != word and alt not in words:
            words[alt] = words[word]
    return chars, words


def _table_jyutping(text: str) -> List[str]:
    chars, words = _vendored_table()
    max_w = max((len(w) for w in words), default=1)
    out: List[str] = []
    i = 0
    while i < len(text):
        ch = text[i]
        if ch in PUNCTUATION_SET:
            out.append(ch)
            i += 1
            continue
        matched = False
        for ln in range(min(max_w, len(text) - i), 1, -1):
            cand = text[i:i + ln]
            if cand in words:
                out += words[cand]
                i += ln
                matched = True
                break
        if matched:
            continue
        jp = chars.get(ch)
        if jp:
            out.append(jp)
        # unknown hanzi dropped (reference drops unmatched syllables too)
        i += 1
    return out


def get_jyutping(text: str) -> List[str]:
    try:
        import ToJyutping

        out: List[str] = []
        for ch, jp in ToJyutping.get_jyutping_list(text):
            if ch in PUNCTUATION_SET:
                out.append(ch)
            elif jp is not None:
                out.append(jp)
        return out
    except ImportError:
        pass
    try:
        from pyjyutping import jyutping as _pj

        jp = _pj.convert(text)
        for symbol in PUNCTUATION:
            jp = jp.replace(symbol, " " + symbol + " ")
        return jp.split()
    except ImportError:
        pass
    return _table_jyutping(text)


# ---------------------------------------------------------------------------
# jyutping -> phones (reference cantonese.py:120-172, behavior-identical)
# ---------------------------------------------------------------------------


def jyuping_to_initials_finals_tones(
        syllables: List[str]) -> Tuple[List[str], List[int]]:
    initials_finals: List[str] = []
    tones: List[int] = []
    word2ph: List[int] = []

    for syllable in syllables:
        if syllable in PUNCTUATION_SET or syllable == "_":
            initials_finals.append(syllable)
            tones.append(0)
            word2ph.append(1)
            continue
        try:
            tone = int(syllable[-1])
            body = syllable[:-1]
        except ValueError:
            tone = 0
            body = syllable
        for initial in INITIALS:
            if body.startswith(initial):
                if body.startswith("nga"):
                    initials_finals += [body[:2], body[2:] or body[-1]]
                else:
                    initials_finals += [initial,
                                        body[len(initial):] or initial[-1]]
                tones += [-1, tone]
                word2ph.append(2)
                break

    phones = []
    for a, b in zip(initials_finals, tones):
        todo = f"{a}{b}" if b not in (-1, 0) else a
        if todo not in PUNCTUATION_SET:
            todo = f"Y{todo}"
        phones.append(todo)
    return phones, word2ph


def g2p(norm_text: str) -> Tuple[List[str], List[int]]:
    return jyuping_to_initials_finals_tones(get_jyutping(norm_text))
