"""Korean pronunciation rules (standard 표준발음법 phonology).

Dependency-free replacement for the deterministic core of ``g2pk2``
(the reference imports g2pk2 as a hard dep:
src/easevoice/text/korean.py:6,227-270).  Converts written hangul to
pronounced hangul: number spell-out, then syllable-boundary phonology —
obstruent neutralization, consonant-cluster simplification, liaison,
ㅎ-aspiration/deletion, palatalization, nasalization, lateralization and
tensification — plus the written-vowel adjustments (ㅈ/ㅉ/ㅊ+ㅕ→ㅓ,
consonant+ㅢ→ㅣ).

Known divergences from g2pk2 (documented, morphology-dependent):
* no mecab POS pass, so suffix-only rules (verb ㄴ-insertion, 어간 ㄹ
  tensification, josa 의) are applied by their common-case default;
* palatalization (ㄷ/ㅌ + 이) is applied unconditionally;
* liaison is applied within contiguous hangul runs only (spaces block).
"""
from __future__ import annotations

import re
from typing import List, Optional

_CHO = "ㄱㄲㄴㄷㄸㄹㅁㅂㅃㅅㅆㅇㅈㅉㅊㅋㅌㅍㅎ"
_JUNG = "ㅏㅐㅑㅒㅓㅔㅕㅖㅗㅘㅙㅚㅛㅜㅝㅞㅟㅠㅡㅢㅣ"
_JONG = ["", "ㄱ", "ㄲ", "ㄳ", "ㄴ", "ㄵ", "ㄶ", "ㄷ", "ㄹ", "ㄺ", "ㄻ",
         "ㄼ", "ㄽ", "ㄾ", "ㄿ", "ㅀ", "ㅁ", "ㅂ", "ㅄ", "ㅅ", "ㅆ", "ㅇ",
         "ㅈ", "ㅊ", "ㅋ", "ㅌ", "ㅍ", "ㅎ"]

_CLUSTER = {"ㄳ": ("ㄱ", "ㅅ"), "ㄵ": ("ㄴ", "ㅈ"), "ㄶ": ("ㄴ", "ㅎ"),
            "ㄺ": ("ㄹ", "ㄱ"), "ㄻ": ("ㄹ", "ㅁ"), "ㄼ": ("ㄹ", "ㅂ"),
            "ㄽ": ("ㄹ", "ㅅ"), "ㄾ": ("ㄹ", "ㅌ"), "ㄿ": ("ㄹ", "ㅍ"),
            "ㅀ": ("ㄹ", "ㅎ"), "ㅄ": ("ㅂ", "ㅅ")}
# 자음군 단순화 (representative member kept before a consonant / finally)
_SIMPLIFY = {"ㄳ": "ㄱ", "ㄵ": "ㄴ", "ㄶ": "ㄴ", "ㄺ": "ㄱ", "ㄻ": "ㅁ",
             "ㄼ": "ㄹ", "ㄽ": "ㄹ", "ㄾ": "ㄹ", "ㄿ": "ㅂ", "ㅀ": "ㄹ"}
_SIMPLIFY["ㅄ"] = "ㅂ"
# 평파열음화
_NEUTRAL = {"ㄲ": "ㄱ", "ㅋ": "ㄱ", "ㅅ": "ㄷ", "ㅆ": "ㄷ", "ㅈ": "ㄷ",
            "ㅊ": "ㄷ", "ㅌ": "ㄷ", "ㅎ": "ㄷ", "ㅍ": "ㅂ"}
_ASPIRATE = {"ㄱ": "ㅋ", "ㄲ": "ㅋ", "ㄷ": "ㅌ", "ㅅ": "ㅌ", "ㅆ": "ㅌ",
             "ㅈ": "ㅊ", "ㅊ": "ㅊ", "ㅌ": "ㅌ", "ㅂ": "ㅍ", "ㅍ": "ㅍ"}
_TENSE = {"ㄱ": "ㄲ", "ㄷ": "ㄸ", "ㅂ": "ㅃ", "ㅅ": "ㅆ", "ㅈ": "ㅉ"}
_NASAL = {"ㄱ": "ㅇ", "ㄷ": "ㄴ", "ㅂ": "ㅁ"}


class _Syl:
    __slots__ = ("cho", "jung", "jong")

    def __init__(self, cho: str, jung: str, jong: str):
        self.cho, self.jung, self.jong = cho, jung, jong

    def char(self) -> str:
        return chr(0xAC00 + _CHO.index(self.cho) * 588
                   + _JUNG.index(self.jung) * 28 + _JONG.index(self.jong))


def _split_syl(ch: str) -> Optional[_Syl]:
    code = ord(ch) - 0xAC00
    if not (0 <= code < 11172):
        return None
    cho, rest = divmod(code, 588)
    jung, jong = divmod(rest, 28)
    return _Syl(_CHO[cho], _JUNG[jung], _JONG[jong])


# ---------------------------------------------------------------------------
# number spell-out (g2pk2 convert_num semantics, as vendored by the
# reference's korean.py:120-215)
# ---------------------------------------------------------------------------

_CLASSIFIERS = ("군데 권 개 그루 닢 대 두 마리 모 모금 뭇 발 발짝 방 번 벌 "
                "보루 살 수 술 시 쌈 움큼 정 짝 채 척 첩 축 켤레 톨 통").split()


def spell_number(num: str, sino: bool = True) -> str:
    num = num.replace(",", "")
    if num == "0":
        return "영"
    if not sino and num == "20":
        return "스무"
    digit2name = dict(zip("123456789", "일이삼사오육칠팔구"))
    digit2mod = dict(zip("123456789", "한 두 세 네 다섯 여섯 일곱 여덟 "
                                      "아홉".split()))
    digit2dec = dict(zip("123456789", "열 스물 서른 마흔 쉰 예순 일흔 여든 "
                                      "아흔".split()))
    units = {2: "백", 3: "천", 4: "만", 5: "십", 6: "백", 7: "천", 8: "억",
             9: "십", 10: "백", 11: "천", 12: "조", 13: "십", 14: "백",
             15: "천"}
    out: List[str] = []
    for pos, digit in enumerate(num):
        i = len(num) - pos - 1
        if i == 0:
            name = digit2name.get(digit, "") if sino \
                else digit2mod.get(digit, "")
        elif i == 1:
            name = (digit2name.get(digit, "") + "십").replace("일십", "십") \
                if sino else digit2dec.get(digit, "")
        else:
            name = ""
        if digit == "0":
            # a zero still emits the 만/억/조 group marker when the group
            # above it was non-empty (reference korean.py:152-160)
            if i % 4 == 0:
                if "".join(out[-min(3, len(out)):]) == "":
                    out.append("")
                    continue
            else:
                out.append("")
                continue
        if i >= 2:
            name = digit2name.get(digit, "") + units.get(i, "")
            if i in (2, 3, 4, 5, 6, 7):
                name = name.replace("일" + units[i], units[i])
        out.append(name)
    return "".join(out)


def convert_numbers(text: str) -> str:
    for num, classifier in set(re.findall(r"(\d[\d,]*)([가-휟]+)",
                                          text)):
        sino = not (classifier[:2] in _CLASSIFIERS
                    or classifier[0] in _CLASSIFIERS)
        text = text.replace(f"{num}{classifier}",
                            f"{spell_number(num, sino)}{classifier}")
    for d, n in zip("0123456789", "영일이삼사오육칠팔구"):
        text = text.replace(d, n)
    return text


# ---------------------------------------------------------------------------
# phonology
# ---------------------------------------------------------------------------


def _boundary(cur: _Syl, nxt: _Syl) -> None:
    g, n = cur.jong, nxt.cho
    vowel_next = n == "ㅇ"

    # --- ㅎ-final codas -----------------------------------------------------
    if g in ("ㅎ", "ㄶ", "ㅀ"):
        base = {"ㅎ": "", "ㄶ": "ㄴ", "ㅀ": "ㄹ"}[g]
        if n in ("ㄱ", "ㄷ", "ㅈ"):
            nxt.cho = _ASPIRATE[n]
            cur.jong = base
            return
        if n == "ㅅ":
            nxt.cho = "ㅆ"
            cur.jong = base
            return
        if vowel_next:                       # ㅎ deletes; base liaises
            cur.jong = ""
            if base:
                nxt.cho = base
            return
        if n == "ㄴ":
            cur.jong = base if base else "ㄷ"  # 놓는 handled by nasalization
        else:
            cur.jong = base if base else "ㄷ"
        # fall through to consonant-boundary rules with the reduced coda
        g = cur.jong
        if not g:
            return

    # --- coda + ㅎ onset: aspiration ---------------------------------------
    if n == "ㅎ" and g:
        first, last = _CLUSTER.get(g, ("", g))
        if last in _ASPIRATE and last not in ("ㄴ", "ㄹ", "ㅁ", "ㅇ"):
            nxt.cho = _ASPIRATE[last]
            cur.jong = first
            return
        return

    # --- palatalization (ㄷ/ㅌ(+ㄾ) + 이) ----------------------------------
    if vowel_next and nxt.jung == "ㅣ" and g in ("ㄷ", "ㅌ", "ㄾ"):
        if g == "ㄷ":
            cur.jong, nxt.cho = "", "ㅈ"
        elif g == "ㅌ":
            cur.jong, nxt.cho = "", "ㅊ"
        else:
            cur.jong, nxt.cho = "ㄹ", "ㅊ"
        return

    # --- liaison ------------------------------------------------------------
    if vowel_next:
        if not g or g == "ㅇ":
            return
        if g in _CLUSTER:
            first, last = _CLUSTER[g]
            cur.jong = first
            nxt.cho = "ㅆ" if last == "ㅅ" else last   # 값이 -> 갑씨
        else:
            cur.jong = ""
            nxt.cho = g
        return

    if not g:
        return

    # --- consonant onset: simplify + neutralize the coda --------------------
    if g == "ㄺ" and n == "ㄱ":               # 맑게 -> 말께
        cur.jong = "ㄹ"
        nxt.cho = "ㄲ"
        return
    # 어간-final ㄵ/ㄼ/ㄾ/ㄽ keep tensifying the suffix onset after the
    # obstruent member is dropped (표준발음법 24/25 — applied by default;
    # rare noun exceptions like 여덟+조사 need POS and diverge)
    stem_tense = g in ("ㄵ", "ㄼ", "ㄾ", "ㄽ")
    if g in _CLUSTER:
        if g == "ㄼ" and cur.jung == "ㅏ" and cur.cho == "ㅂ":
            g = "ㅂ"                          # 밟- exception
        else:
            g = _SIMPLIFY[g]
    g = _NEUTRAL.get(g, g)
    cur.jong = g
    if stem_tense and n in _TENSE:
        nxt.cho = _TENSE[n]
        return

    # --- lateralization ------------------------------------------------------
    if g == "ㄴ" and n == "ㄹ":
        cur.jong = "ㄹ"
        return
    if g == "ㄹ" and n == "ㄴ":
        nxt.cho = "ㄹ"
        return

    # --- nasalization / tensification ---------------------------------------
    if g in ("ㄱ", "ㄷ", "ㅂ"):
        if n in ("ㄴ", "ㅁ"):
            cur.jong = _NASAL[g]
        elif n == "ㄹ":
            cur.jong = _NASAL[g]
            nxt.cho = "ㄴ"
        elif n in _TENSE:
            nxt.cho = _TENSE[n]
        return
    if g in ("ㅁ", "ㅇ") and n == "ㄹ":
        nxt.cho = "ㄴ"


def _finalize(syl: _Syl) -> None:
    g = syl.jong
    if g in _CLUSTER:
        if g == "ㄼ" and syl.jung == "ㅏ" and syl.cho == "ㅂ":
            g = "ㅂ"
        else:
            g = _SIMPLIFY[g]
    syl.jong = _NEUTRAL.get(g, g)


def pronounce(text: str) -> str:
    """Written hangul -> pronounced hangul (g2pk2-equivalent core)."""
    text = convert_numbers(text)
    items: List = [(_split_syl(ch) or ch) for ch in text]

    # written-vowel adjustments
    for it in items:
        if isinstance(it, _Syl):
            if it.cho in ("ㅈ", "ㅉ", "ㅊ") and it.jung == "ㅕ":
                it.jung = "ㅓ"
            if it.cho != "ㅇ" and it.jung == "ㅢ":
                it.jung = "ㅣ"

    for i, it in enumerate(items):
        if not isinstance(it, _Syl):
            continue
        nxt = items[i + 1] if i + 1 < len(items) else None
        if isinstance(nxt, _Syl):
            _boundary(it, nxt)
        else:
            _finalize(it)

    return "".join(it.char() if isinstance(it, _Syl) else it for it in items)
