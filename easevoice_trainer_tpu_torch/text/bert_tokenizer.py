"""BERT WordPiece tokenizer with ``transformers.BertTokenizer`` semantics,
so that the port's BERT and G2PW models tokenize without ``transformers``
(the JAX package asks ``AutoTokenizer.from_pretrained`` for it:
models/bert.py:182-184, text/g2pw.py:218-222).

Basic tokenizing cleans control characters, puts spaces around each CJK
character, optionally lower-cases and strips accents, and splits on
punctuation; then each word is split greedily, longest match first, into
vocabulary pieces (``##`` for continuations), or is ``[UNK]`` as a whole.
"""
from __future__ import annotations

import json
import os
import unicodedata
from typing import Dict, List, Optional

BERT_CLASSES = ("BertTokenizer", "BertTokenizerFast")
SPECIALS = ("unk_token", "sep_token", "pad_token", "cls_token", "mask_token")
_DEFAULT_SPECIALS = {"unk_token": "[UNK]", "sep_token": "[SEP]",
                     "pad_token": "[PAD]", "cls_token": "[CLS]",
                     "mask_token": "[MASK]"}


def _is_whitespace(ch: str) -> bool:
    return ch in " \t\n\r" or unicodedata.category(ch) == "Zs"


def _is_control(ch: str) -> bool:
    return ch not in "\t\n\r" and unicodedata.category(ch).startswith("C")


def _is_punctuation(ch: str) -> bool:
    cp = ord(ch)
    if 33 <= cp <= 47 or 58 <= cp <= 64 or 91 <= cp <= 96 \
            or 123 <= cp <= 126:
        return True
    return unicodedata.category(ch).startswith("P")


def _is_cjk(cp: int) -> bool:
    return (0x4E00 <= cp <= 0x9FFF or 0x3400 <= cp <= 0x4DBF
            or 0x20000 <= cp <= 0x2A6DF or 0x2A700 <= cp <= 0x2B73F
            or 0x2B740 <= cp <= 0x2B81F or 0x2B820 <= cp <= 0x2CEAF
            or 0xF900 <= cp <= 0xFAFF or 0x2F800 <= cp <= 0x2FA1F)


def _read_json(path: str) -> dict:
    if not os.path.isfile(path):
        return {}
    with open(path, encoding="utf8") as f:
        return json.load(f)


def loadable(model_dir: str) -> bool:
    """``model_dir`` holds a BERT tokenizer that ``AutoTokenizer`` finds
    locally: a vocabulary (``vocab.txt``, or ``tokenizer.json``) and a
    tokenizer_config.json naming a BERT tokenizer class, or else a
    config.json of model type ``bert``."""
    has = lambda n: os.path.isfile(os.path.join(model_dir, n))  # noqa: E731
    if not (has("vocab.txt") or has("tokenizer.json")):
        return False
    try:
        cls = _read_json(os.path.join(model_dir, "tokenizer_config.json")
                         ).get("tokenizer_class")
        if cls is not None:
            return cls in BERT_CLASSES
        return _read_json(os.path.join(model_dir, "config.json")
                          ).get("model_type") == "bert"
    except (OSError, ValueError):
        return False


class BertTokenizer:
    """``vocab``: token -> id.  The options are BertTokenizer's."""

    def __init__(self, vocab: Dict[str, int], do_lower_case: bool = True,
                 strip_accents: Optional[bool] = None,
                 tokenize_chinese_chars: bool = True,
                 max_input_chars_per_word: int = 100,
                 specials: Optional[Dict[str, str]] = None):
        self.vocab = vocab
        self.do_lower_case = do_lower_case
        self.strip_accents = strip_accents
        self.tokenize_chinese_chars = tokenize_chinese_chars
        self.max_input_chars_per_word = max_input_chars_per_word
        sp = {**_DEFAULT_SPECIALS, **(specials or {})}
        self.unk_token, self.cls_token, self.sep_token = (
            sp["unk_token"], sp["cls_token"], sp["sep_token"])
        self.never_split = set(sp.values())

    @classmethod
    def from_pretrained(cls, model_dir: str) -> "BertTokenizer":
        """From ``vocab.txt`` (one token a line, its id the line number) or
        the WordPiece vocabulary of ``tokenizer.json``, with the options of
        ``tokenizer_config.json``; raises where :func:`loadable` is false."""
        if not loadable(model_dir):
            raise FileNotFoundError(f"no BERT tokenizer in {model_dir}")
        cfg = _read_json(os.path.join(model_dir, "tokenizer_config.json"))
        vocab_txt = os.path.join(model_dir, "vocab.txt")
        max_chars = 100
        if os.path.isfile(vocab_txt):
            with open(vocab_txt, encoding="utf8") as f:
                vocab = {line.rstrip("\n"): i for i, line in enumerate(f)}
        else:
            model = _read_json(os.path.join(model_dir, "tokenizer.json")
                               )["model"]
            if model.get("type") != "WordPiece":
                raise ValueError(f"{model_dir}/tokenizer.json is not a "
                                 f"WordPiece model")
            vocab = dict(model["vocab"])
            max_chars = model.get("max_input_chars_per_word", max_chars)
        specials = {}
        for key in SPECIALS:
            tok = cfg.get(key)
            if isinstance(tok, dict):
                tok = tok.get("content")
            if tok:
                specials[key] = tok
        return cls(vocab, do_lower_case=cfg.get("do_lower_case", True),
                   strip_accents=cfg.get("strip_accents"),
                   tokenize_chinese_chars=cfg.get("tokenize_chinese_chars",
                                                  True),
                   max_input_chars_per_word=max_chars, specials=specials)

    # -- basic tokenizing ----------------------------------------------------

    def _basic(self, text: str) -> List[str]:
        out = []
        for ch in text:
            cp = ord(ch)
            if cp == 0 or cp == 0xFFFD or _is_control(ch):
                continue
            if _is_whitespace(ch):
                out.append(" ")
            elif self.tokenize_chinese_chars and _is_cjk(cp):
                out += [" ", ch, " "]
            else:
                out.append(ch)
        text = unicodedata.normalize("NFC", "".join(out))
        pieces: List[str] = []
        for token in text.split():
            if token not in self.never_split:
                if self.do_lower_case:
                    token = token.lower()
                    if self.strip_accents is not False:
                        token = self._strip_accents(token)
                elif self.strip_accents:
                    token = self._strip_accents(token)
            pieces += self._split_on_punc(token)
        return " ".join(pieces).split()

    @staticmethod
    def _strip_accents(token: str) -> str:
        return "".join(ch for ch in unicodedata.normalize("NFD", token)
                       if unicodedata.category(ch) != "Mn")

    def _split_on_punc(self, token: str) -> List[str]:
        if token in self.never_split:
            return [token]
        words: List[List[str]] = []
        start_new = True
        for ch in token:
            if _is_punctuation(ch):
                words.append([ch])
                start_new = True
            else:
                if start_new:
                    words.append([])
                start_new = False
                words[-1].append(ch)
        return ["".join(w) for w in words]

    # -- WordPiece ---------------------------------------------------------------

    def _wordpiece(self, word: str) -> List[str]:
        if len(word) > self.max_input_chars_per_word:
            return [self.unk_token]
        pieces = []
        start = 0
        while start < len(word):
            end = len(word)
            piece = None
            while start < end:
                sub = word[start:end]
                if start > 0:
                    sub = "##" + sub
                if sub in self.vocab:
                    piece = sub
                    break
                end -= 1
            if piece is None:
                return [self.unk_token]
            pieces.append(piece)
            start = end
        return pieces

    # -- API -----------------------------------------------------------------------

    def tokenize(self, text: str) -> List[str]:
        tokens = []
        for word in self._basic(text):
            tokens += [word] if word in self.never_split \
                else self._wordpiece(word)
        return tokens

    def convert_tokens_to_ids(self, tokens: List[str]) -> List[int]:
        unk = self.vocab.get(self.unk_token)
        return [self.vocab.get(t, unk) for t in tokens]

    def __call__(self, text: str) -> Dict[str, List[int]]:
        """``input_ids`` with [CLS] and [SEP] around the text's tokens, and
        an ``attention_mask`` of the same length."""
        ids = self.convert_tokens_to_ids(
            [self.cls_token] + self.tokenize(text) + [self.sep_token])
        return {"input_ids": ids, "attention_mask": [1] * len(ids)}
