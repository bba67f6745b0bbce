"""Korean G2P.

Reference pipeline (src/easevoice/text/korean.py:227-270): latin→hangul,
g2pk2 pronunciation rules, jamo decomposition (compatibility jamo with
diphthongs split), the g2pk2 을/를+ㄹ fix, a trailing '.' after a final
jamo, and per-symbol post replacement (space→空, out-of-inventory→停).

The pronunciation-rule step uses ``g2pk2`` when importable (matching the
reference's hard dependency) and otherwise this repo's dependency-free
implementation of the same phonology (:mod:`.korean_rules`).
"""
from __future__ import annotations

import re
from typing import List

from .symbols import SYMBOLS

_CHO = "ㄱㄲㄴㄷㄸㄹㅁㅂㅃㅅㅆㅇㅈㅉㅊㅋㅌㅍㅎ"
_JUNG = ["ㅏ", "ㅐ", "ㅑ", "ㅒ", "ㅓ", "ㅔ", "ㅕ", "ㅖ", "ㅗ", "ㅘ", "ㅙ",
         "ㅚ", "ㅛ", "ㅜ", "ㅝ", "ㅞ", "ㅟ", "ㅠ", "ㅡ", "ㅢ", "ㅣ"]
_JONG = ["", "ㄱ", "ㄲ", "ㄳ", "ㄴ", "ㄵ", "ㄶ", "ㄷ", "ㄹ", "ㄺ", "ㄻ",
         "ㄼ", "ㄽ", "ㄾ", "ㄿ", "ㅀ", "ㅁ", "ㅂ", "ㅄ", "ㅅ", "ㅆ", "ㅇ",
         "ㅈ", "ㅊ", "ㅋ", "ㅌ", "ㅍ", "ㅎ"]

# diphthongs split to inventory jamo (reference _hangul_divided — cluster
# finals are left to the pronunciation rules, same as the reference)
_DIVIDE = {"ㅘ": "ㅗㅏ", "ㅙ": "ㅗㅐ", "ㅚ": "ㅗㅣ", "ㅝ": "ㅜㅓ",
           "ㅞ": "ㅜㅔ", "ㅟ": "ㅜㅣ", "ㅢ": "ㅡㅣ", "ㅑ": "ㅣㅏ",
           "ㅒ": "ㅣㅐ", "ㅕ": "ㅣㅓ", "ㅖ": "ㅣㅔ", "ㅛ": "ㅣㅗ",
           "ㅠ": "ㅣㅜ"}
# safety net for cluster finals that survive (rules resolve them normally)
_DIVIDE_JONG = {"ㄳ": "ㄱㅅ", "ㄵ": "ㄴㅈ", "ㄶ": "ㄴㅎ", "ㄺ": "ㄹㄱ",
                "ㄻ": "ㄹㅁ", "ㄼ": "ㄹㅂ", "ㄽ": "ㄹㅅ", "ㄾ": "ㄹㅌ",
                "ㄿ": "ㄹㅍ", "ㅀ": "ㄹㅎ", "ㅄ": "ㅂㅅ"}

_LATIN_TO_HANGUL = [
    ("a", "에이"), ("b", "비"), ("c", "시"), ("d", "디"), ("e", "이"),
    ("f", "에프"), ("g", "지"), ("h", "에이치"), ("i", "아이"),
    ("j", "제이"), ("k", "케이"), ("l", "엘"), ("m", "엠"), ("n", "엔"),
    ("o", "오"), ("p", "피"), ("q", "큐"), ("r", "아르"), ("s", "에스"),
    ("t", "티"), ("u", "유"), ("v", "브이"), ("w", "더블유"),
    ("x", "엑스"), ("y", "와이"), ("z", "제트")]

_REP_MAP = {"：": ",", "；": ",", "，": ",", "。": ".", "！": "!",
            "？": "?", "\n": ".", "·": ",", "、": ",", "...": "…",
            " ": "空"}


def latin_to_hangul(text: str) -> str:
    for latin, hangul in _LATIN_TO_HANGUL:
        text = re.sub(latin, hangul, text, flags=re.IGNORECASE)
    return text


def _pronounce(text: str) -> str:
    try:
        from g2pk2 import G2p

        return G2p()(text)
    except Exception:
        from . import korean_rules

        return korean_rules.pronounce(text)


def decompose(ch: str) -> List[str]:
    code = ord(ch) - 0xAC00
    if not (0 <= code < 11172):
        return [ch]
    cho, rest = divmod(code, 588)
    jung, jong = divmod(rest, 28)
    out = [_CHO[cho], *_DIVIDE.get(_JUNG[jung], _JUNG[jung])]
    if _JONG[jong]:
        out += list(_DIVIDE_JONG.get(_JONG[jong], _JONG[jong]))
    return out


def divide_hangul(text: str) -> str:
    return "".join("".join(decompose(ch)) for ch in text)


def fix_g2pk2_error(text: str) -> str:
    """을/를 + ㄹ-initial next word: ㄹ denasalises to ㄴ (reference
    korean.py:94-106)."""
    new_text = ""
    i = 0
    while i < len(text) - 4:
        if (text[i:i + 3] in ("ㅇㅡㄹ", "ㄹㅡㄹ") and text[i + 3] == " "
                and text[i + 4] == "ㄹ"):
            new_text += text[i:i + 3] + " " + "ㄴ"
            i += 5
        else:
            new_text += text[i]
            i += 1
    new_text += text[i:]
    return new_text


def post_replace_ph(ph: str) -> str:
    ph = _REP_MAP.get(ph, ph)
    return ph if ph in SYMBOLS else "停"


def text_normalize(text: str) -> str:
    # the reference has no Korean text_normalize; numbers and latin are
    # handled inside g2p.  Kept as identity for the cleaner contract.
    return text


def g2p(norm_text: str) -> List[str]:
    text = latin_to_hangul(norm_text)
    text = _pronounce(text)
    text = divide_hangul(text)
    text = fix_g2pk2_error(text)
    text = re.sub(r"([ㄱ-ㅣ])$", r"\1.", text)
    return [post_replace_ph(ch) for ch in text]
