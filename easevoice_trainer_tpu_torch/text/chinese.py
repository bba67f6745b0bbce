"""Chinese G2P: TN -> jieba segmentation -> pinyin -> sandhi -> symbols.

Pipeline modeled on the reference Chinese frontend
(reference: src/easevoice/text/chinese.py:76-305): normalize to
hanzi+punctuation, segment with jieba posseg, read each syllable to a
(initial, final+tone) pair, apply tone sandhi and erhua merging, then map
the normalized pinyin to the 2-symbol inventory via the opencpop-strict
table (i/u/v rewrite rules included).

Pinyin readings come from a pluggable backend:
  1. ``pypinyin`` when installed (reference default without G2PW);
  2. a char/word->pinyin JSON table at $EASEVOICE_PINYIN_TABLE (generated by
     tools/build_pinyin_table.py on a machine with pypinyin);
  3. otherwise a clear error naming the missing dependency.
Polyphones are read by the G2PW model (``text/g2pw.py``, a BERT
classifier on ``set_g2pw_device``'s device, the card by default) where the
JAX package builds its predictor: a loadable G2PWModel directory at
$EASEVOICE_G2PW_DIR or <base>/models/G2PWModel; elsewhere the dictionary
readings above, the reference's ``is_g2pw=False`` path.
"""
from __future__ import annotations

import json
import os
import re
from functools import lru_cache
from typing import Dict, List, Tuple

from ..utils import paths
from .symbols import PUNCTUATION
from .chinese_norm import TextNormalizer
from .tone_sandhi import ToneSandhi

_REP_MAP = {
    "：": ",", "；": ",", "，": ",", "。": ".", "！": "!", "？": "?",
    "\n": ".", "·": ",", "、": ",", "...": "…", "$": ".", "/": ",",
    "—": "-", "~": "…", "～": "…",
}

_MUST_ERHUA = {"小院儿", "胡同儿", "范儿", "老汉儿", "撒欢儿", "寻老礼儿",
               "妥妥儿", "媳妇儿"}
_NOT_ERHUA = {
    "虐儿", "为儿", "护儿", "瞒儿", "救儿", "替儿", "有儿", "一儿", "我儿",
    "俺儿", "妻儿", "拐儿", "聋儿", "乞儿", "患儿", "幼儿", "孤儿", "婴儿",
    "婴幼儿", "连体儿", "脑瘫儿", "流浪儿", "体弱儿", "混血儿", "蜜雪儿",
    "舫儿", "祖儿", "美儿", "应采儿", "可儿", "侄儿", "孙儿", "侄孙儿",
    "女儿", "男儿", "红孩儿", "花儿", "虫儿", "马儿", "鸟儿", "猪儿",
    "猫儿", "狗儿", "少儿",
}

_NORMALIZER = TextNormalizer()
_SANDHI = ToneSandhi()


@lru_cache(maxsize=1)
def pinyin_to_symbol_map() -> Dict[str, List[str]]:
    path = os.path.join(os.path.dirname(__file__), "data",
                        "opencpop_strict.json")
    with open(path, encoding="utf8") as f:
        return json.load(f)


# ---------------------------------------------------------------------------
# pinyin backends
# ---------------------------------------------------------------------------


class PinyinBackendError(RuntimeError):
    pass


@lru_cache(maxsize=1)
def polyphonic_words() -> Dict[str, List[str]]:
    """word -> per-char TONE3 readings (vendored g2pw polyphonic data).

    The reference applies these as post-corrections over G2PW output
    (reference: text/g2pw/g2pw.py correct_pronunciation); here they also
    upgrade the table backend's per-char default readings.
    """
    path = os.path.join(os.path.dirname(__file__), "data", "polyphonic.json")
    if not os.path.exists(path):
        return {}
    with open(path, encoding="utf8") as f:
        return json.load(f)


def correct_pronunciation(word: str,
                          pairs: List[Tuple[str, str]]) -> List[Tuple[str, str]]:
    readings = polyphonic_words().get(word)
    if readings and len(readings) == len(pairs):
        return [split_initial_final(r) for r in readings]
    return pairs


@lru_cache(maxsize=1)
def _backend():
    try:
        from pypinyin import lazy_pinyin, Style

        def fn(word: str) -> List[Tuple[str, str]]:
            inits = lazy_pinyin(word, neutral_tone_with_five=True,
                                style=Style.INITIALS)
            finals = lazy_pinyin(word, neutral_tone_with_five=True,
                                 style=Style.FINALS_TONE3)
            return list(zip(inits, finals))

        return fn
    except ImportError:
        pass

    table_path = os.environ.get("EASEVOICE_PINYIN_TABLE", os.path.join(
        os.path.dirname(__file__), "data", "pinyin_table.json"))
    if os.path.exists(table_path):
        with open(table_path, encoding="utf8") as f:
            table: Dict[str, List[str]] = json.load(f)

        poly = polyphonic_words()

        def fn(word: str) -> List[Tuple[str, str]]:
            # polyphonic word dict, then table word entry, then per-char
            sylls: List[str] = []
            if word in poly:
                sylls = list(poly[word])
            elif word in table:
                sylls = list(table[word])
            else:
                for ch in word:
                    entry = table.get(ch)
                    sylls.append(entry[0] if entry else ch)
            return [split_initial_final(s) for s in sylls]

        return fn

    raise PinyinBackendError(
        "Chinese G2P needs a pinyin source: install `pypinyin` or provide a "
        "char->pinyin JSON table via EASEVOICE_PINYIN_TABLE "
        "(see tools/build_pinyin_table.py)")


_G2PW_DEVICE = "cuda"


def set_g2pw_device(device) -> None:
    """The device the G2PW model runs on (the card unless a caller asks for
    the CPU, as ``TTS`` does with ``TTSConfig.device``); clears the cached
    predictor."""
    global _G2PW_DEVICE
    _G2PW_DEVICE = str(device)
    _g2pw_predictor.cache_clear()


@lru_cache(maxsize=1)
def _g2pw_predictor():
    """Model-based polyphone disambiguation when a G2PWModel dir exists.

    Mirrors the reference's ``is_g2pw`` switch (reference:
    src/easevoice/text/chinese.py:16-28, 212) as the JAX package does: the
    model directory is looked up at $EASEVOICE_G2PW_DIR or
    <base>/models/G2PWModel; absent, or not loadable (``text/g2pw.py``:
    tables, a BERT tokenizer, named weights) -> dictionary backend only.
    The model runs on ``set_g2pw_device``'s device.  Cached; call
    ``cache_clear`` after changing the environment.
    """
    if os.environ.get("EASEVOICE_DISABLE_G2PW"):
        return None
    model_dir = os.environ.get("EASEVOICE_G2PW_DIR") or os.path.join(
        paths.get_base_path(), "models", "G2PWModel")
    if not os.path.isdir(model_dir):
        return None
    from .g2pw import G2PWPredictor

    predictor = G2PWPredictor(model_dir, _G2PW_DEVICE)
    return predictor if predictor.available else None


def _char_fallback(ch: str) -> str:
    """Single-char TONE3 reading from the word backend (g2pw fallback)."""
    c, v = _backend()(ch)[0]
    return ch if c == v else c + v


_INITIALS = ["zh", "ch", "sh", "b", "p", "m", "f", "d", "t", "n", "l", "g",
             "k", "h", "j", "q", "x", "r", "z", "c", "s", "y", "w"]


def split_initial_final(syllable: str) -> Tuple[str, str]:
    """'zhong4' -> ('zh', 'ong4'); punctuation passes through as (p, p)."""
    if not syllable or not syllable[0].isalpha():
        return syllable, syllable
    for ini in _INITIALS:
        if syllable.startswith(ini) and len(syllable) > len(ini):
            rest = syllable[len(ini):]
            # pypinyin INITIALS style excludes y/w; fold them into the final
            if ini in ("y", "w"):
                return "", syllable
            return ini, rest
    return "", syllable


# ---------------------------------------------------------------------------
# normalization
# ---------------------------------------------------------------------------


def replace_punctuation(text: str) -> str:
    text = text.replace("嗯", "恩").replace("呣", "母")
    pattern = re.compile("|".join(re.escape(p) for p in _REP_MAP))
    text = pattern.sub(lambda m: _REP_MAP[m.group()], text)
    text = re.sub(r"[^一-龥" + "".join(PUNCTUATION) + r"]+", "", text)
    return text


def text_normalize(text: str) -> str:
    out = "".join(replace_punctuation(s) for s in _NORMALIZER.normalize(text))
    punct = "".join(re.escape(p) for p in PUNCTUATION)
    return re.sub(f"([{punct}])([{punct}])+", r"\1", out)


# ---------------------------------------------------------------------------
# g2p
# ---------------------------------------------------------------------------


def _merge_erhua(initials: List[str], finals: List[str], word: str,
                 pos: str) -> Tuple[List[str], List[str]]:
    # er1 at word end reads er2 (reference: chinese.py:140-143)
    for i in range(len(finals)):
        if i == len(finals) - 1 and word[i] == "儿" and finals[i] == "er1":
            finals[i] = "er2"
    if word not in _MUST_ERHUA and (word in _NOT_ERHUA
                                    or pos in {"a", "j", "nr"}):
        return initials, finals
    if len(finals) != len(word):
        return initials, finals
    new_initials: List[str] = []
    new_finals: List[str] = []
    for i, phn in enumerate(finals):
        if (i == len(finals) - 1 and word[i] == "儿"
                and phn in {"er2", "er5"} and word[-2:] not in _NOT_ERHUA
                and new_finals):
            phn = "er" + new_finals[-1][-1]
        new_initials.append(initials[i])
        new_finals.append(phn)
    return new_initials, new_finals


_V_REWRITE = {"uei": "ui", "iou": "iu", "uen": "un"}
_STANDALONE_REWRITE = {"ing": "ying", "i": "yi", "in": "yin", "u": "wu"}
_STANDALONE_PREFIX = {"v": "yu", "e": "e", "i": "y", "u": "w"}


def _pinyin_pair_to_phones(c: str, v: str) -> Tuple[List[str], int]:
    if c == v:  # punctuation syllable
        return [c], 1
    v_no_tone, tone = v[:-1], v[-1]
    assert tone in "12345", (c, v)
    pinyin = c + v_no_tone
    if c:
        pinyin = c + _V_REWRITE.get(v_no_tone, v_no_tone)
    else:
        if pinyin in _STANDALONE_REWRITE:
            pinyin = _STANDALONE_REWRITE[pinyin]
        elif pinyin and pinyin[0] in _STANDALONE_PREFIX:
            pinyin = _STANDALONE_PREFIX[pinyin[0]] + pinyin[1:]
    mapping = pinyin_to_symbol_map().get(pinyin)
    if mapping is None:
        return ["UNK", "UNK"], 2
    if isinstance(mapping, str):
        mapping = mapping.split(" ")
    new_c, new_v = mapping
    return [new_c, new_v + tone], 2


def _g2p_segments(segments: List[str]) -> Tuple[List[str], List[int]]:
    import jieba.posseg as posseg

    backend = _backend()
    predictor = _g2pw_predictor()
    phones: List[str] = []
    word2ph: List[int] = []
    for seg in segments:
        seg = re.sub("[a-zA-Z]+", "", seg)
        seg_cut = _SANDHI.pre_merge_for_modify(
            [(w, p) for w, p in posseg.lcut(seg)])
        readings = (predictor.lazy_pinyin(seg, _char_fallback)
                    if predictor is not None else None)
        initials: List[str] = []
        finals: List[str] = []
        cursor = 0
        for word, pos in seg_cut:
            cursor_end = cursor + len(word)
            if pos == "eng":
                cursor = cursor_end
                continue
            if readings is not None:
                # model path (reference chinese.py:212-241): per-char
                # readings from G2PW, then word-level dict corrections
                pairs = [split_initial_final(r)
                         for r in readings[cursor:cursor_end]]
            else:
                pairs = backend(word)
            cursor = cursor_end
            pairs = correct_pronunciation(word, pairs)
            sub_initials = [c for c, _ in pairs]
            sub_finals = [v for _, v in pairs]
            sub_finals = _SANDHI.modified_tone(word, pos, sub_finals)
            sub_initials, sub_finals = _merge_erhua(
                sub_initials, sub_finals, word, pos)
            initials += sub_initials
            finals += sub_finals
        for c, v in zip(initials, finals):
            phs, n = _pinyin_pair_to_phones(c, v)
            phones += phs
            word2ph.append(n)
    return phones, word2ph


def g2p(text: str) -> Tuple[List[str], List[int]]:
    pattern = r"(?<=[{0}])\s*".format("".join(PUNCTUATION))
    sentences = [s for s in re.split(pattern, text) if s.strip()]
    return _g2p_segments(sentences)
