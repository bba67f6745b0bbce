"""Synthesis text preprocessing: split -> per-segment G2P + BERT features.

Rebuild of the reference TextPreprocessor
(reference: src/easevoice/inference/preprocessor.py:43-227): pre-segment via
the chosen split method, merge short segments (<5 chars), cap at 510 chars
for BERT, then per segment route language runs (the reference uses the
LangSegment package; here a script-based router covers the same zh/ja/ko/en
split), G2P each run, and attach 1024-d phone-level BERT features (zeros for
non-Chinese, as the reference does).
"""
from __future__ import annotations

import re
from typing import Dict, List, Optional, Tuple

import numpy as np

from ..text.cleaner import clean_text
from ..text.symbols import PUNCTUATION, cleaned_text_to_sequence
from .segmentation import SPLITS, get_split_method


# Han chars that exist only in Japanese orthography: shinjitai
# simplifications that differ from both zh-simplified and traditional,
# plus kokuji (Japan-made chars).  Any of these marks a Han run as ja.
_JA_ONLY_HAN = set(
    # shinjitai forms + kokuji that do not occur in ordinary Chinese text.
    # Characters with real (if rare) zh usage are deliberately excluded:
    # 箇 (trad. 個 variant), 弁, 丼 (zh menu loan), 竜, 畑-adjacent forms.
    "駅円絵売読続転図広営桜気沢労伝実剣済単拝仏変挙釈録焼縄験騒辺塀斉渋"
    "弐壱斎畳働峠辻込匂凪榊躾雫栃枠凧凩鰯匁麿笹"
)


def detect_language_runs(text: str) -> List[Tuple[str, str]]:
    """Script-based language segmentation -> [(lang, run), ...].

    Han codepoints are shared between zh and ja; script inspection alone
    cannot split them (the reference resolves this contextually with
    LangSegment, preprocessor.py:110-178).  Policy here: a Han run whose
    directly adjacent run is kana is Japanese — in Japanese text kanji are
    tightly interleaved with kana particles/okurigana, while Chinese text
    contains no kana at all.  Pure-Han text therefore stays zh, and
    kana-flanked kanji route to the Japanese G2P.
    """
    def script(ch: str) -> Optional[str]:
        o = ord(ch)
        if 0x4E00 <= o <= 0x9FFF or 0x3400 <= o <= 0x4DBF:
            return "zh"
        if 0x3040 <= o <= 0x30FF or 0x31F0 <= o <= 0x31FF:
            return "ja"
        if 0xAC00 <= o <= 0xD7AF or 0x1100 <= o <= 0x11FF:
            return "ko"
        if ch.isascii() and (ch.isalpha() or ch == "'"):
            return "en"
        return None  # punctuation/space: attach to the current run

    # sentence-boundary markers block kana-adjacency propagation
    _BOUNDARY = "。！？!?…\n"
    runs: List[Tuple[str, str]] = []
    boundary_after: List[bool] = []
    cur_lang: Optional[str] = None
    buf = ""
    for ch in text:
        s = script(ch)
        if s is None or s == cur_lang:
            buf += ch
            if s is None and ch in _BOUNDARY and buf:
                runs.append((cur_lang or "zh", buf))
                boundary_after.append(True)
                cur_lang, buf = None, ""
            continue
        if buf:
            runs.append((cur_lang or s, buf))
            boundary_after.append(False)
        cur_lang, buf = s, ch
    if buf:
        runs.append((cur_lang or "zh", buf))
        boundary_after.append(False)

    # kana adjacency: Han runs directly flanked by Japanese (within the
    # same sentence) read as Japanese.  Pure-Han runs can still be
    # Japanese: shinjitai forms and kokuji exist only in Japanese
    # orthography, so any such char flips the run (駅, 円, 売, 働, …).
    labels = [lang for lang, _ in runs]
    for i, lang in enumerate(labels):
        if lang != "zh":
            continue
        prev_ja = (i > 0 and labels[i - 1] == "ja"
                   and not boundary_after[i - 1])
        next_ja = (i + 1 < len(runs) and runs[i + 1][0] == "ja"
                   and not boundary_after[i])
        if prev_ja or next_ja or any(ch in _JA_ONLY_HAN
                                     for ch in runs[i][1]):
            labels[i] = "ja"
    merged: List[Tuple[str, str]] = []
    for lang, run in zip(labels, (r for _, r in runs)):
        if merged and merged[-1][0] == lang:
            merged[-1] = (lang, merged[-1][1] + run)
        else:
            merged.append((lang, run))
    return merged


def merge_short_text_in_array(texts: List[str], threshold: int) -> List[str]:
    if len(texts) < 2:
        return texts
    out: List[str] = []
    acc = ""
    for t in texts:
        acc += t
        if len(acc) >= threshold:
            out.append(acc)
            acc = ""
    if acc:
        if out:
            out[-1] += acc
        else:
            out.append(acc)
    return out


def split_big_text(text: str, max_len: int = 510) -> List[str]:
    return [text[i:i + max_len] for i in range(0, len(text), max_len)]


class TextPreprocessor:
    """bert_extractor: models.bert.BertFeatureExtractor or None."""

    def __init__(self, bert_extractor=None):
        self.bert = bert_extractor

    # ---- public API ---------------------------------------------------------

    def preprocess(self, text: str, lang: str,
                   text_split_method: str) -> List[Dict]:
        text = self._dedup_punct(text)
        segments = self.pre_seg_text(text, lang, text_split_method)
        result = []
        for seg in segments:
            phones, bert_features, norm_text = self.get_phones_and_bert(
                seg, lang)
            if not phones or norm_text == "":
                continue
            result.append({"phones": phones, "bert_features": bert_features,
                           "norm_text": norm_text})
        return result

    def pre_seg_text(self, text: str, lang: str,
                     text_split_method: str) -> List[str]:
        text = text.strip("\n")
        if not text:
            return []
        first_len = len(re.split(f"[{re.escape(''.join(SPLITS))}]",
                                 text, 1)[0])
        if text[0] not in SPLITS and first_len < 4:
            text = ("。" if lang != "en" else ".") + text

        text = get_split_method(text_split_method)(text)
        while "\n\n" in text:
            text = text.replace("\n\n", "\n")
        parts = [t for t in text.split("\n") if t not in (None, "", " ")]
        if not parts:
            raise ValueError("All texts are empty")
        parts = merge_short_text_in_array(parts, 5)
        out: List[str] = []
        for t in parts:
            if not t.strip() or not re.sub(r"\W+", "", t):
                continue
            if t[-1] not in SPLITS:
                t += "。" if lang != "en" else "."
            if len(t) > 510:
                out.extend(split_big_text(t))
            else:
                out.append(t)
        return out

    # ---- per-segment --------------------------------------------------------

    def get_phones_and_bert(self, text: str, language: str,
                            final: bool = False):
        if language in {"en", "all_zh", "all_ja", "all_ko", "all_yue"}:
            lang = language.replace("all_", "")
            formattext = re.sub("  +", " ", text)
            phones, word2ph, norm_text = self._clean(formattext, lang)
            if lang == "zh":
                bert = self._bert_feature(norm_text, word2ph, len(phones))
            else:
                bert = np.zeros((1024, len(phones)), np.float32)
        else:
            # mixed/auto: route script runs
            base = None if language in ("auto", "auto_yue") else language
            phones_list, bert_list, norm_list = [], [], []
            for run_lang, run in detect_language_runs(text):
                lang = run_lang
                if base and run_lang != "en":
                    lang = base
                if language == "auto_yue" and lang == "zh":
                    lang = "yue"
                phs, word2ph, norm = self._clean(run, lang)
                if not phs:
                    continue
                if lang == "zh":
                    bert_list.append(
                        self._bert_feature(norm, word2ph, len(phs)))
                else:
                    bert_list.append(np.zeros((1024, len(phs)), np.float32))
                phones_list.append(phs)
                norm_list.append(norm)
            phones = sum(phones_list, [])
            bert = (np.concatenate(bert_list, axis=1) if bert_list
                    else np.zeros((1024, 0), np.float32))
            norm_text = "".join(norm_list)

        if not final and len(phones) < 6:
            return self.get_phones_and_bert("." + text, language, final=True)
        return phones, bert, norm_text

    def _clean(self, text: str, language: str):
        phones, word2ph, norm_text = clean_text(text, language)
        return cleaned_text_to_sequence(phones), word2ph, norm_text

    def _bert_feature(self, norm_text: str, word2ph, n_phones: int):
        if self.bert is not None and word2ph is not None:
            try:
                return self.bert.phone_features(norm_text, word2ph)
            except NotImplementedError:
                raise   # a model this package has not ported (tts.py)
            except Exception:
                pass
        return np.zeros((1024, n_phones), np.float32)

    @staticmethod
    def _dedup_punct(text: str) -> str:
        punct = "".join(re.escape(p) for p in PUNCTUATION)
        return re.sub(f"([{punct}])([{punct}])+", r"\1", text)
