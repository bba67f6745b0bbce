"""Text splitting methods for synthesis.

Same six methods and registry contract as the reference
(reference: src/easevoice/inference/segmentation.py:52-191): each method
takes raw text and returns newline-joined segments; segments that are pure
punctuation are dropped.
"""
from __future__ import annotations

import re
from enum import Enum
from typing import Callable, Dict, List, Union

SPLITS = {"，", "。", "？", "！", ",", ".", "?", "!", "~", ":", "：",
          "—", "…"}

PUNCTUATION_SET = SPLITS | {";", "；", "、", "'", '"', " ", "\n"}


def split_sentences(text: str) -> List[str]:
    """Split into sentences keeping the trailing punctuation."""
    out: List[str] = []
    buf = ""
    for ch in text:
        buf += ch
        if ch in SPLITS:
            out.append(buf)
            buf = ""
    if buf:
        out.append(buf)
    return out


class SplitMethods(Enum):
    NoSplit = "no_split"
    By4Sentences = "by_4_sentences"
    By50Chars = "by_50_chars"
    ByChinesePeriod = "by_chinese_period"
    ByEnglishPeriod = "by_english_period"
    ByPunctuation = "by_punctuation"


_SPLIT_METHODS: Dict[str, Callable[[str], str]] = {}


def _register(name: SplitMethods):
    def deco(fn):
        _SPLIT_METHODS[name.value] = fn
        return fn
    return deco


def get_split_method(name: Union[SplitMethods, str]) -> Callable[[str], str]:
    key = name.value if isinstance(name, SplitMethods) else name
    method = _SPLIT_METHODS.get(key)
    if method is None:
        raise ValueError(f"Cut method {name} not found")
    return method


def get_split_names() -> List[str]:
    return list(_SPLIT_METHODS)


def _only_punct(s: str) -> bool:
    return bool(s) and set(s).issubset(PUNCTUATION_SET)


def _join(parts: List[str]) -> str:
    return "\n".join(p for p in parts if p and not _only_punct(p))


@_register(SplitMethods.NoSplit)
def no_split(text: str) -> str:
    return text if not _only_punct(text) else "\n"


@_register(SplitMethods.By4Sentences)
def by_4_sentences(text: str) -> str:
    sents = split_sentences(text.strip("\n"))
    groups = ["".join(sents[i:i + 4]) for i in range(0, len(sents), 4)]
    return _join(groups) if groups else text


@_register(SplitMethods.By50Chars)
def by_50_chars(text: str) -> str:
    sents = split_sentences(text.strip("\n"))
    if len(sents) < 2:
        return text
    groups: List[str] = []
    buf, count = "", 0
    for s in sents:
        buf += s
        count += len(s)
        if count > 50:
            groups.append(buf)
            buf, count = "", 0
    if buf:
        groups.append(buf)
    if len(groups) > 1 and len(groups[-1]) < 50:
        groups[-2] += groups[-1]
        groups.pop()
    return _join(groups)


@_register(SplitMethods.ByChinesePeriod)
def by_chinese_period(text: str) -> str:
    return _join(text.strip("\n").strip("。").split("。"))


@_register(SplitMethods.ByEnglishPeriod)
def by_english_period(text: str) -> str:
    return _join(text.strip("\n").strip(".").split("."))


@_register(SplitMethods.ByPunctuation)
def by_punctuation(text: str) -> str:
    puncts = {",", ".", ";", "?", "!", "、", "，", "。", "？", "！", "；",
              "：", "…"}
    parts: List[str] = []
    buf = ""
    for i, ch in enumerate(text.strip("\n")):
        buf += ch
        if ch in puncts:
            # keep decimal points intact (3.14)
            if (ch == "." and 0 < i < len(text) - 1 and text[i - 1].isdigit()
                    and text[i + 1].isdigit()):
                continue
            parts.append(buf)
            buf = ""
    if buf:
        parts.append(buf)
    return _join(parts)
