"""Phoneme symbol inventory (v2, 732 symbols).

The inventory is *vocabulary data*: pretrained GPT-SoVITS checkpoints index
their text embeddings by these exact IDs
(reference: src/easevoice/text/symbols.py — zh initials/finals with tones,
Japanese prosody marks, ARPAbet, Korean jamo, Cantonese jyutping, shared
punctuation, sorted-set ordering with ko/yue appended).  It is shipped as a
JSON data file extracted from the reference vocabulary so IDs line up
bit-exactly with released checkpoints.
"""
from __future__ import annotations

import json
import os
from typing import Iterable, List

PUNCTUATION = ["!", "?", "…", ",", ".", "-"]
PUNCTUATION_SET = set(PUNCTUATION)

_DATA = os.path.join(os.path.dirname(__file__), "data", "symbols_v2.json")

with open(_DATA, encoding="utf8") as _f:
    SYMBOLS: List[str] = json.load(_f)

SYMBOLS_TO_ID = {s: i for i, s in enumerate(SYMBOLS)}
UNK_ID = SYMBOLS_TO_ID.get("UNK")


def cleaned_text_to_sequence(cleaned_text: Iterable[str]) -> List[int]:
    """Phoneme strings -> symbol IDs; unknown phonemes map to UNK."""
    return [SYMBOLS_TO_ID.get(s, UNK_ID) for s in cleaned_text]


def sequence_to_symbols(ids: Iterable[int]) -> List[str]:
    return [SYMBOLS[i] for i in ids]
