"""clean_text: language dispatch for the multilingual G2P frontend.

Contract identical to the reference cleaner
(reference: src/easevoice/text/cleaner.py:23-77):
``clean_text(text, lang) -> (phones, word2ph, norm_text)`` with

* unknown languages falling back to English over a blank text;
* zh special markers ￥ -> SP2, ^ -> SP3 (silent-segment symbols);
* zh/yue returning per-character ``word2ph``; others ``None``;
* very short English phone lists padded with a leading comma;
* any out-of-inventory phone mapped to UNK.
"""
from __future__ import annotations

from typing import List, Optional, Tuple

from .symbols import SYMBOLS

SPECIAL = [("￥", "zh", "SP2"), ("^", "zh", "SP3")]


def _module(language: str):
    from . import chinese, english, japanese, korean, cantonese

    return {"zh": chinese, "ja": japanese, "en": english, "ko": korean,
            "yue": cantonese}[language]


def clean_text(text: str, language: str
               ) -> Tuple[List[str], Optional[List[int]], str]:
    if language not in ("zh", "ja", "en", "ko", "yue"):
        language = "en"
        text = " "

    for marker, lang, target in SPECIAL:
        if marker in text and language == lang:
            return _clean_special(text, language, marker, target)

    mod = _module(language)
    norm_text = mod.text_normalize(text) if hasattr(mod, "text_normalize") \
        else text

    if language in ("zh", "yue"):
        phones, word2ph = mod.g2p(norm_text)
        assert len(phones) == sum(word2ph)
        if language == "zh":
            assert len(norm_text) == len(word2ph), (norm_text, word2ph)
    elif language == "en":
        phones = mod.g2p(norm_text)
        if len(phones) < 4:
            phones = [","] + phones
        word2ph = None
    else:
        phones = mod.g2p(norm_text)
        word2ph = None

    phones = [ph if ph in SYMBOLS else "UNK" for ph in phones]
    return phones, word2ph, norm_text


def _clean_special(text: str, language: str, marker: str, target: str):
    text = text.replace(marker, ",")
    mod = _module(language)
    norm_text = mod.text_normalize(text)
    phones, word2ph = mod.g2p(norm_text)
    new_ph = [target if ph == "," else ph for ph in phones]
    new_ph = [ph if ph in SYMBOLS else "UNK" for ph in new_ph]
    return new_ph, word2ph, norm_text
