"""Japanese G2P (pyopenjtalk prosody marks, with a vendored fallback).

The reference uses pyopenjtalk's full-context labels to emit phonemes with
prosody symbols ([ ] # ^ $ ?; reference: src/easevoice/text/japanese.py:
109-236), splitting the input on non-Japanese marks and stripping the
^/$/? sentence anchors per segment (preprocess_jap:109-130).

Without pyopenjtalk this module falls back to a vendored pipeline:

* kanji→kana via ``data/kanji_readings.json`` (greedy word lookup, then
  on-readings for kanji compounds / kun-readings for single kanji —
  unknown kanji are dropped with a log line);
* kana→phoneme with youon digraphs (きゃ→ky a), sokuon→q, hatsuon→N,
  long vowels (ー and お+う) collapsed to the repeated vowel;
* accent-phrase segmentation (particles close a phrase, auxiliaries
  like です/ます attach) with a curated Tokyo pitch-accent table
  (``data/ja_accents.json``); each phrase emits the same contour marks
  the reference derives from full-context labels (espnet rules,
  reference japanese.py:195-213): '[' rise after the first mora,
  ']' fall after the accent-nucleus mora, '#' at phrase borders.
  Words absent from the accent table default to heiban (0-type) — the
  pre-accent fallback behavior, now only for unknown vocabulary.
"""
from __future__ import annotations

import json
import os
import re
from functools import lru_cache
from typing import List

from .symbols import PUNCTUATION
from ..utils.logger import logger

_REP_MAP = {"：": ",", "；": ",", "，": ",", "。": ".", "！": "!", "？": "?",
            "\n": ".", "·": ",", "、": ",", "...": "…"}

# reference japanese.py:41-48
_JAPANESE_CHARS = re.compile(
    r"[A-Za-z\d々぀-ヿ一-鿿１-９Ａ-Ｚ"
    r"ａ-ｚｦ-ﾝ]")
_JAPANESE_MARKS = re.compile(
    r"[^A-Za-z\d々぀-ヿ一-鿿１-９Ａ-Ｚ"
    r"ａ-ｚｦ-ﾝ]")
_SYMBOLS_TO_JAPANESE = [(re.compile("％"), "パーセント")]

_KATA_START = 0x30A1
_HIRA_START = 0x3041

# base kana -> phones; youon digraphs are composed below
_KANA_ROMAJI = {
    "あ": "a", "い": "i", "う": "u", "え": "e", "お": "o",
    "か": "k a", "き": "k i", "く": "k u", "け": "k e", "こ": "k o",
    "が": "g a", "ぎ": "g i", "ぐ": "g u", "げ": "g e", "ご": "g o",
    "さ": "s a", "し": "sh i", "す": "s u", "せ": "s e", "そ": "s o",
    "ざ": "z a", "じ": "j i", "ず": "z u", "ぜ": "z e", "ぞ": "z o",
    "た": "t a", "ち": "ch i", "つ": "ts u", "て": "t e", "と": "t o",
    "だ": "d a", "ぢ": "j i", "づ": "z u", "で": "d e", "ど": "d o",
    "な": "n a", "に": "n i", "ぬ": "n u", "ね": "n e", "の": "n o",
    "は": "h a", "ひ": "h i", "ふ": "f u", "へ": "h e", "ほ": "h o",
    "ば": "b a", "び": "b i", "ぶ": "b u", "べ": "b e", "ぼ": "b o",
    "ぱ": "p a", "ぴ": "p i", "ぷ": "p u", "ぺ": "p e", "ぽ": "p o",
    "ま": "m a", "み": "m i", "む": "m u", "め": "m e", "も": "m o",
    "や": "y a", "ゆ": "y u", "よ": "y o",
    "ら": "r a", "り": "r i", "る": "r u", "れ": "r e", "ろ": "r o",
    "わ": "w a", "ゐ": "i", "ゑ": "e", "を": "o", "ん": "N",
    "ゔ": "v u",
    "ぁ": "a", "ぃ": "i", "ぅ": "u", "ぇ": "e", "ぉ": "o",
}
# consonant-i kana + small ゃゅょ -> youon initial
_YOUON_INITIAL = {"き": "ky", "ぎ": "gy", "し": "sh", "じ": "j",
                  "ち": "ch", "ぢ": "j", "に": "ny", "ひ": "hy",
                  "び": "by", "ぴ": "py", "み": "my", "り": "ry"}
_SMALL_Y = {"ゃ": "a", "ゅ": "u", "ょ": "o"}
_SMALL_VOWELS = {"ぁ": "a", "ぃ": "i", "ぅ": "u", "ぇ": "e", "ぉ": "o"}
_VOWELS = {"a", "i", "u", "e", "o"}


@lru_cache(maxsize=1)
def _readings():
    here = os.path.dirname(os.path.abspath(__file__))
    with open(os.path.join(here, "data", "kanji_readings.json"),
              encoding="utf-8") as fp:
        data = json.load(fp)
    # derive inflection stems: 楽しい->たのしい also yields 楽し->たのし so
    # conjugated forms (楽しかった) resolve through the word path
    words = dict(data["words"])
    for w, r in list(words.items()):
        if (len(w) >= 2 and len(r) >= 2 and w[-1] == r[-1]
                and "ぁ" <= w[-1] <= "ゖ"):
            stem, rs = w[:-1], r[:-1]
            if _KANJI.search(stem) and stem not in words:
                words[stem] = rs
    data = dict(data)
    data["words"] = words
    return data


def text_normalize(text: str) -> str:
    for p, r in _REP_MAP.items():
        text = text.replace(p, r)
    # avoid reference leakage from repeated punctuation (reference:96-100)
    punct = "".join(re.escape(p) for p in PUNCTUATION)
    return re.sub(f"([{punct}])([{punct}])+", r"\1", text)


def _kata_to_hira(text: str) -> str:
    return "".join(
        chr(ord(ch) - _KATA_START + _HIRA_START)
        if _KATA_START <= ord(ch) <= 0x30F6 else ch
        for ch in text)


_KANJI = re.compile(r"[一-鿿々]")


def kanji_to_kana(text: str) -> str:
    """Greedy word lookup, then on (compounds) / kun (single) readings."""
    data = _readings()
    words, on, kun = data["words"], data["on"], data["kun"]
    max_w = max(len(w) for w in words)
    out: List[str] = []
    i = 0
    while i < len(text):
        matched = False
        for ln in range(min(max_w, len(text) - i), 1, -1):
            cand = text[i:i + ln]
            if cand in words:
                out.append(words[cand])
                i += ln
                matched = True
                break
        if matched:
            continue
        ch = text[i]
        if not _KANJI.match(ch):
            # は directly after a kanji word is the topic particle (わ)
            if ch == "は" and i > 0 and (_KANJI.match(text[i - 1])
                                         or text[i - 1] in "んンー"):
                out.append("わ")
            else:
                out.append(ch)
            i += 1
            continue
        if ch in words:
            out.append(words[ch])
            i += 1
            continue
        # bare kanji run: length >= 2 -> on readings, single -> kun
        j = i
        while j < len(text) and _KANJI.match(text[j]):
            j += 1
        run = text[i:j]
        table = on if len(run) >= 2 else kun
        for k in run:
            reading = table.get(k) or on.get(k) or kun.get(k)
            if reading:
                out.append(reading)
            else:
                logger.debug("ja fallback: unknown kanji %r dropped", k)
        i = j
    return "".join(out)


def _kana_phones(kana: str) -> List[List[str]]:
    """Hiragana -> list of moras (each a list of phone tokens)."""
    moras: List[List[str]] = []
    i = 0
    while i < len(kana):
        ch = kana[i]
        nxt = kana[i + 1] if i + 1 < len(kana) else ""
        if ch in _YOUON_INITIAL and nxt in _SMALL_Y:
            moras.append([_YOUON_INITIAL[ch], _SMALL_Y[nxt]])
            i += 2
            continue
        if nxt in _SMALL_VOWELS and ch in _KANA_ROMAJI and ch not in "んっ":
            base = _KANA_ROMAJI[ch].split(" ")
            if len(base) == 2:
                moras.append([base[0], _SMALL_VOWELS[nxt]])
                i += 2
                continue
        if ch == "っ":
            moras.append(["q"])
            i += 1
            continue
        if ch == "ー":
            prev_vowel = next((p for m in reversed(moras)
                               for p in reversed(m) if p in _VOWELS), None)
            if prev_vowel:
                moras.append([prev_vowel])
            i += 1
            continue
        if ch == "う" and moras and moras[-1] and moras[-1][-1] == "o":
            moras.append(["o"])            # お+う long vowel
            i += 1
            continue
        if ch in _KANA_ROMAJI:
            moras.append(_KANA_ROMAJI[ch].split(" "))
            i += 1
            continue
        i += 1                              # unknown char dropped
    return moras


@lru_cache(maxsize=1)
def _accents():
    here = os.path.dirname(os.path.abspath(__file__))
    with open(os.path.join(here, "data", "ja_accents.json"),
              encoding="utf-8") as fp:
        return json.load(fp)


# particles close an accent phrase when they follow dictionary-derived
# content; を is a pure particle in modern Japanese and always closes
_PARTICLES = set("はがをにでともへやのねよ")
_PARTICLE_READS = {"は": "わ", "へ": "え"}
# espnet emits '#' only after vowel/N/cl phones (reference japanese.py:206)
_BORDER_OK = {"a", "i", "u", "e", "o", "N", "q"}


def _phrase_split(sentence: str) -> List[tuple]:
    """Segment into accent phrases -> [(kana, accent_type_or_None)].

    Words (kanji surface or phrase-initial kana) carry accents from
    ja_accents.json; auxiliaries attach, shifting a heiban phrase's
    nucleus by their relative accent; particles close the phrase.
    """
    data = _readings()
    acc = _accents()
    words, on, kun = data["words"], data["on"], data["kun"]
    wacc, kacc, aux = acc["words"], acc["kana"], acc["aux"]
    max_w = max(len(w) for w in words)
    max_k = max(len(w) for w in kacc)
    max_a = max(len(w) for w in aux)

    phrases: List[tuple] = []
    cur, cur_acc = "", None
    from_dict = False      # current phrase content came from a word table
    closed = True          # next content starts a new phrase

    def close():
        nonlocal cur, cur_acc, from_dict
        if cur:
            phrases.append((cur, cur_acc))
        cur, cur_acc, from_dict = "", None, False

    i, n = 0, len(sentence)
    while i < n:
        # kanji-surface word
        matched = False
        for ln in range(min(max_w, n - i), 1, -1):
            cand = sentence[i:i + ln]
            if cand in words:
                close()
                cur, cur_acc = words[cand], wacc.get(cand)
                from_dict, closed = True, False
                i += ln
                matched = True
                break
        if matched:
            continue
        ch = sentence[i]
        if _KANJI.match(ch):
            if ch in words:
                close()
                cur, cur_acc = words[ch], wacc.get(ch)
                from_dict, closed = True, False
                i += 1
                continue
            # bare kanji run: length >= 2 -> on readings, single -> kun
            j = i
            while j < n and _KANJI.match(sentence[j]):
                j += 1
            run = sentence[i:j]
            table = on if len(run) >= 2 else kun
            reading = ""
            for k in run:
                r = table.get(k) or on.get(k) or kun.get(k)
                if r:
                    reading += r
                else:
                    logger.debug("ja fallback: unknown kanji %r dropped", k)
            if reading:
                close()
                cur, cur_acc, from_dict, closed = reading, None, True, False
            i = j
            continue
        # auxiliary attaching to a non-empty phrase (です/ます/さん ...)
        if cur:
            amatch = None
            for ln in range(min(max_a, n - i), 0, -1):
                cand = _kata_to_hira(sentence[i:i + ln])
                if cand in aux:
                    amatch = cand
                    break
            if amatch is not None:
                a = aux[amatch]
                if a and cur_acc in (None, 0):
                    cur_acc = len(_kana_phones(cur)) + a
                cur += amatch
                from_dict = True
                i += len(amatch)
                continue
        # kana-spelled word at phrase start
        if closed or not cur:
            kmatch = None
            for ln in range(min(max_k, n - i), 1, -1):
                cand = _kata_to_hira(sentence[i:i + ln])
                if cand in kacc:
                    kmatch = cand
                    break
            if kmatch is not None:
                close()
                reading, a = kacc[kmatch]
                cur, cur_acc, from_dict, closed = reading, a, True, False
                i += len(kmatch)
                continue
        h = _kata_to_hira(ch)
        # particle closes the phrase (after dictionary words; を always)
        if cur and not closed and h in _PARTICLES and (from_dict or h == "を"):
            cur += _PARTICLE_READS.get(h, h)
            close()
            closed = True
            i += 1
            continue
        cur += h
        i += 1
    close()
    return phrases


def _fallback_sentence(sentence: str) -> List[str]:
    phrases = _phrase_split(sentence)
    phones: List[str] = []
    for pi, (kana, accent) in enumerate(phrases):
        if pi == len(phrases) - 1:
            # final topic particle reads わ/え (こんにちは -> konnichiwa)
            if kana.endswith("は"):
                kana = kana[:-1] + "わ"
            elif kana.endswith("へ"):
                kana = kana[:-1] + "え"
        moras = _kana_phones(kana)
        if not moras:
            continue
        M = len(moras)
        A = accent or 0
        if A > M:
            A = 0
        last_phrase = pi == len(phrases) - 1
        # espnet contour rules (reference japanese.py:204-213): border
        # first, then nucleus fall (not phrase-final), then initial rise
        for k, mora in enumerate(moras, 1):
            phones += mora
            if k == M:
                if not last_phrase and phones and phones[-1] in _BORDER_OK:
                    phones.append("#")
            elif k == A:
                phones.append("]")
            elif k == 1 and A != 1:
                phones.append("[")
    return phones


def g2p(norm_text: str) -> List[str]:
    try:
        import pyopenjtalk  # noqa: F401

        have_ojt = True
    except ImportError:
        have_ojt = False

    # reference preprocess_jap:109-130 — split on marks, strip ^/$ anchors
    for regex, replacement in _SYMBOLS_TO_JAPANESE:
        norm_text = regex.sub(replacement, norm_text)
    norm_text = norm_text.lower()
    sentences = re.split(_JAPANESE_MARKS, norm_text)
    marks = re.findall(_JAPANESE_MARKS, norm_text)
    phones: List[str] = []
    for i, sentence in enumerate(sentences):
        if re.match(_JAPANESE_CHARS, sentence):
            if have_ojt:
                phones += _g2p_prosody(sentence)[1:-1]
            else:
                phones += _fallback_sentence(sentence)
        if i < len(marks):
            mark = marks[i].replace(" ", "")
            if mark:
                phones.append(mark)
    return [_REP_MAP.get(ph, ph) for ph in phones]


def _g2p_prosody(text: str) -> List[str]:
    """Full-context-label G2P with prosody marks (reference:142-227)."""
    import pyopenjtalk

    labels = pyopenjtalk.make_label(pyopenjtalk.run_frontend(text))
    N = len(labels)
    phones: List[str] = []
    for n in range(N):
        lab = labels[n]
        p3 = re.search(r"\-(.*?)\+", lab).group(1)
        if p3 in ("sil",):
            if n == 0:
                phones.append("^")
            elif n == N - 1:
                e3 = int(re.search(r"!(\d+)_", lab).group(1))
                phones.append("$" if e3 == 0 else "?")
            continue
        if p3 == "pau":
            phones.append("_")
            continue
        phones.append(p3.replace("cl", "q"))
        # accent marks
        a1 = int(re.search(r"/A:([0-9\-]+)\+", lab).group(1))
        a2 = int(re.search(r"\+(\d+)\+", lab).group(1))
        a3 = int(re.search(r"\+(\d+)/", lab).group(1))
        f1 = int(re.search(r"/F:(\d+)_", lab).group(1))
        if n + 1 < N:
            nxt = re.search(r"\-(.*?)\+", labels[n + 1]).group(1)
        else:
            nxt = ""
        a2_next = (int(re.search(r"\+(\d+)\+", labels[n + 1]).group(1))
                   if n + 1 < N and nxt not in ("sil", "pau") else -1)
        if a3 == 1 and a2_next == 1:
            phones.append("#")
        elif a1 == 0 and a2_next == a2 + 1 and a2 != f1:
            phones.append("]")
        elif a2 == 1 and a2_next == 2:
            phones.append("[")
    return phones
