"""Mandarin tone sandhi applied to per-word final lists.

Full rule set of the reference ToneSandhi (reference:
src/easevoice/text/tone_sandhi.py:22-807, PaddleSpeech lineage):

* segment pre-merging (不/一/reduplication/consecutive-third-tone/儿) so the
  per-word rules see whole sandhi domains;
* 不: neutral inside X不X, tone 2 before tone 4;
* 一: untouched in digit strings, neutral between reduplicated verbs,
  tone 1 in 第一, tone 2 before tone 4, else tone 4 (not before punctuation);
* neutral tone: sentence-final particles, 的地得, single 了着过 (pos u*),
  们/子 with noun/pronoun pos, locatives 上下里, directionals 来去 after
  上下进出回过起开, quantifier 个, plus the 420-word must-neural list
  (vendored at data/sandhi_words.json) checked on the word and its tail and
  on jieba sub-words;
* third-tone sandhi over 2/3/4-syllable words with jieba-driven splitting.

Finals carry the tone as a trailing digit ("ang4"); rules rewrite only that
digit.  The word-level readings used by the merge passes come from the
pluggable pinyin backend in chinese.py (the reference calls pypinyin
directly).
"""
from __future__ import annotations

import json
import os
from functools import lru_cache
from typing import List, Sequence, Tuple

Seg = List[Tuple[str, str]]


@lru_cache(maxsize=1)
def _word_lists():
    path = os.path.join(os.path.dirname(__file__), "data",
                        "sandhi_words.json")
    with open(path, encoding="utf8") as f:
        d = json.load(f)
    return (frozenset(d["must_neural_tone_words"]),
            frozenset(d["must_not_neural_tone_words"]))


def _word_finals(word: str) -> List[str]:
    """FINALS_TONE3 readings via the chinese.py backend (lazy import to
    avoid a module cycle)."""
    from .chinese import _backend

    return [v for _, v in _backend()(word)]


class ToneSandhi:
    punc = "：，；。？！“”‘’':,;.?!"

    def __init__(self):
        self.must_neural_tone_words, self.must_not_neural_tone_words = \
            _word_lists()

    # ---- per-word rules ----------------------------------------------------

    def _neural_sandhi(self, word: str, pos: str,
                       finals: List[str]) -> List[str]:
        # reduplication for n./v./a., e.g. 奶奶, 试试, 旺旺
        for j, item in enumerate(word):
            if (j >= 1 and item == word[j - 1] and pos[:1] in {"n", "v", "a"}
                    and word not in self.must_not_neural_tone_words):
                finals[j] = finals[j][:-1] + "5"
        ge_idx = word.find("个")
        if len(word) >= 1 and word[-1] in "吧呢哈啊呐噻嘛吖嗨呐哦哒额滴哩哟喽啰耶喔诶":
            finals[-1] = finals[-1][:-1] + "5"
        elif len(word) >= 1 and word[-1] in "的地得":
            finals[-1] = finals[-1][:-1] + "5"
        elif len(word) == 1 and word in "了着过" and pos in {"ul", "uz", "ug"}:
            finals[-1] = finals[-1][:-1] + "5"
        elif (len(word) > 1 and word[-1] in "们子" and pos in {"r", "n"}
              and word not in self.must_not_neural_tone_words):
            finals[-1] = finals[-1][:-1] + "5"
        elif len(word) > 1 and word[-1] in "上下里" and pos in {"s", "l", "f"}:
            finals[-1] = finals[-1][:-1] + "5"
        elif len(word) > 1 and word[-1] in "来去" and word[-2] in "上下进出回过起开":
            finals[-1] = finals[-1][:-1] + "5"
        elif (ge_idx >= 1 and (word[ge_idx - 1].isnumeric()
                               or word[ge_idx - 1] in "几有两半多各整每做是")
              ) or word == "个":
            finals[ge_idx] = finals[ge_idx][:-1] + "5"
        else:
            if (word in self.must_neural_tone_words
                    or word[-2:] in self.must_neural_tone_words):
                finals[-1] = finals[-1][:-1] + "5"

        word_list = self._split_word(word)
        finals_list = [finals[:len(word_list[0])],
                       finals[len(word_list[0]):]]
        for i, sub_word in enumerate(word_list):
            if (sub_word in self.must_neural_tone_words
                    or sub_word[-2:] in self.must_neural_tone_words) \
                    and finals_list[i]:
                finals_list[i][-1] = finals_list[i][-1][:-1] + "5"
        return finals_list[0] + finals_list[1]

    def _bu_sandhi(self, word: str, finals: List[str]) -> List[str]:
        if len(word) == 3 and word[1] == "不":
            finals[1] = finals[1][:-1] + "5"          # 看不懂
        else:
            for i, char in enumerate(word):
                if char == "不" and i + 1 < len(word) \
                        and finals[i + 1][-1] == "4":
                    finals[i] = finals[i][:-1] + "2"  # 不怕
        return finals

    def _yi_sandhi(self, word: str, finals: List[str]) -> List[str]:
        # digit strings stay tone 1 (一零零, 二一零)
        if "一" in word and all(c.isnumeric() for c in word if c != "一"):
            return finals
        if len(word) == 3 and word[1] == "一" and word[0] == word[-1]:
            finals[1] = finals[1][:-1] + "5"          # 看一看
        elif word.startswith("第一"):
            finals[1] = finals[1][:-1] + "1"
        else:
            for i, char in enumerate(word):
                if char == "一" and i + 1 < len(word):
                    if finals[i + 1][-1] == "4":
                        finals[i] = finals[i][:-1] + "2"   # 一段
                    elif word[i + 1] not in self.punc:
                        finals[i] = finals[i][:-1] + "4"   # 一天
        return finals

    def _split_word(self, word: str) -> List[str]:
        import jieba

        word_list = sorted(jieba.cut_for_search(word), key=len)
        first = word_list[0] if word_list else word
        if word.find(first) == 0:
            return [first, word[len(first):]]
        return [word[:-len(first)], first]

    def _all_tone_three(self, finals: Sequence[str]) -> bool:
        return all(x[-1] == "3" for x in finals)

    def _three_sandhi(self, word: str, finals: List[str]) -> List[str]:
        if len(word) == 2 and self._all_tone_three(finals):
            finals[0] = finals[0][:-1] + "2"
        elif len(word) == 3:
            word_list = self._split_word(word)
            if self._all_tone_three(finals):
                if len(word_list[0]) == 2:                 # 蒙古/包
                    finals[0] = finals[0][:-1] + "2"
                    finals[1] = finals[1][:-1] + "2"
                elif len(word_list[0]) == 1:               # 纸/老虎
                    finals[1] = finals[1][:-1] + "2"
            else:
                finals_list = [finals[:len(word_list[0])],
                               finals[len(word_list[0]):]]
                if len(finals_list) == 2:
                    for i, sub in enumerate(finals_list):
                        if self._all_tone_three(sub) and len(sub) == 2:
                            finals_list[i][0] = \
                                finals_list[i][0][:-1] + "2"   # 所有/人
                        elif (i == 1 and not self._all_tone_three(sub)
                              and finals_list[i][0][-1] == "3"
                              and finals_list[0][-1][-1] == "3"):
                            finals_list[0][-1] = \
                                finals_list[0][-1][:-1] + "2"  # 好/喜欢
                        finals = finals_list[0] + finals_list[1]
        elif len(word) == 4:                               # idioms: 2 + 2
            finals_list = [finals[:2], finals[2:]]
            finals = []
            for sub in finals_list:
                if self._all_tone_three(sub):
                    sub[0] = sub[0][:-1] + "2"
                finals += sub
        return finals

    # ---- segment pre-merging -----------------------------------------------

    def _merge_bu(self, seg: Seg) -> Seg:
        new_seg: List[List[str]] = []
        last_word = ""
        for word, pos in seg:
            if last_word == "不":
                word = last_word + word
            if word != "不":
                new_seg.append([word, pos])
            last_word = word[:]
        if last_word == "不":
            new_seg.append([last_word, "d"])
        return [tuple(x) for x in new_seg]

    def _merge_yi(self, seg: Seg) -> Seg:
        new_seg: List[List[str]] = []
        # V 一 V -> V一V
        for i, (word, pos) in enumerate(seg):
            if (i >= 1 and word == "一" and i + 1 < len(seg)
                    and seg[i - 1][0] == seg[i + 1][0]
                    and seg[i - 1][1] == "v" and seg[i + 1][1] == "v"):
                new_seg[i - 1][0] = (new_seg[i - 1][0] + "一"
                                     + new_seg[i - 1][0])
            elif (i >= 2 and seg[i - 1][0] == "一" and seg[i - 2][0] == word
                  and pos == "v" and seg[i - 2][1] == "v"):
                continue
            else:
                new_seg.append([word, pos])
        seg2 = new_seg
        new_seg = []
        # lone 一 merges with the following word
        for word, pos in seg2:
            if new_seg and new_seg[-1][0] == "一":
                new_seg[-1][0] = new_seg[-1][0] + word
            else:
                new_seg.append([word, pos])
        return [tuple(x) for x in new_seg]

    def _is_reduplication(self, word: str) -> bool:
        return len(word) == 2 and word[0] == word[1]

    def _merge_three_tones(self, seg: Seg, whole_word: bool) -> Seg:
        """whole_word=True: both words all-tone-3; False: boundary 3-3."""
        finals_list = [_word_finals(word) for word, _ in seg]
        new_seg: List[List[str]] = []
        merge_last = [False] * len(seg)
        for i, (word, pos) in enumerate(seg):
            if whole_word:
                mergeable = (i >= 1 and self._all_tone_three(finals_list[i - 1])
                             and self._all_tone_three(finals_list[i]))
            else:
                mergeable = (i >= 1 and finals_list[i - 1]
                             and finals_list[i - 1][-1][-1] == "3"
                             and finals_list[i] and
                             finals_list[i][0][-1] == "3")
            if mergeable and not merge_last[i - 1]:
                if (not self._is_reduplication(seg[i - 1][0])
                        and len(seg[i - 1][0]) + len(seg[i][0]) <= 3):
                    new_seg[-1][0] = new_seg[-1][0] + seg[i][0]
                    merge_last[i] = True
                else:
                    new_seg.append([word, pos])
            else:
                new_seg.append([word, pos])
        return [tuple(x) for x in new_seg]

    def _merge_er(self, seg: Seg) -> Seg:
        new_seg: List[List[str]] = []
        for i, (word, pos) in enumerate(seg):
            if i >= 1 and word == "儿" and seg[i - 1][0] != "#":
                new_seg[-1][0] = new_seg[-1][0] + word
            else:
                new_seg.append([word, pos])
        return [tuple(x) for x in new_seg]

    def _merge_reduplication(self, seg: Seg) -> Seg:
        new_seg: List[List[str]] = []
        for word, pos in seg:
            if new_seg and word == new_seg[-1][0]:
                new_seg[-1][0] = new_seg[-1][0] + word
            else:
                new_seg.append([word, pos])
        return [tuple(x) for x in new_seg]

    def pre_merge_for_modify(self, seg: Seg) -> Seg:
        seg = self._merge_bu(seg)
        try:
            seg = self._merge_yi(seg)
        except Exception:
            pass
        seg = self._merge_reduplication(seg)
        try:
            seg = self._merge_three_tones(seg, whole_word=True)
        except Exception:
            pass
        try:
            seg = self._merge_three_tones(seg, whole_word=False)
        except Exception:
            pass
        return self._merge_er(seg)

    def modified_tone(self, word: str, pos: str,
                      finals: List[str]) -> List[str]:
        finals = self._bu_sandhi(word, finals)
        finals = self._yi_sandhi(word, finals)
        finals = self._neural_sandhi(word, pos, finals)
        finals = self._three_sandhi(word, finals)
        return finals
