"""Whisper's byte-level BPE tokenizer, decoding only, with the semantics of
``transformers``' ``WhisperTokenizer.decode(ids, skip_special_tokens=True)``,
so that the port's Whisper reads its directory without ``transformers``
(the JAX package asks ``AutoTokenizer.from_pretrained`` for it:
audiokit/asr_whisper.py:464-505).

Decoding: a prompt run (ids starting with ``<|startofprev|>``) is cut up to
``<|startoftranscript|>``; the special tokens are skipped; the pieces of
the byte-level vocabulary are mapped back to bytes through GPT-2's
byte <-> unicode table and decoded as UTF-8 with replacement characters,
and an added token that is not special (a timestamp ``<|1.00|>``) stands
as its own text; the tokenization spaces are cleaned up where the
directory's ``tokenizer_config.json`` asks for it; timestamp tokens are
removed from the text.  :meth:`WhisperTokenizer.convert_tokens_to_ids`
looks up the ids the forced decoder prompt needs, giving the unknown
token's id (``<|endoftext|>`` for Whisper) for a token it does not hold,
as ``transformers`` does.

The vocabulary comes from ``tokenizer.json`` (the file
``tools/fetch_pretrained.py`` fetches), or else ``vocab.json`` with
``added_tokens.json``; which added tokens are special comes from those
files, ``tokenizer_config.json`` and ``special_tokens_map.json``.
"""
from __future__ import annotations

import json
import os
import re
from typing import Dict, Iterable, List, Optional

_TIMESTAMP = re.compile(r"<\|(\d+\.\d+)\|>")
_SPECIAL_KEYS = ("bos_token", "eos_token", "unk_token", "pad_token")


def bytes_to_unicode() -> Dict[int, str]:
    """GPT-2's map of each byte to a printable unicode character."""
    bs = (list(range(ord("!"), ord("~") + 1))
          + list(range(ord("¡"), ord("¬") + 1))
          + list(range(ord("®"), ord("ÿ") + 1)))
    cs = bs[:]
    n = 0
    for b in range(256):
        if b not in bs:
            bs.append(b)
            cs.append(256 + n)
            n += 1
    return {b: chr(c) for b, c in zip(bs, cs)}


def clean_up_tokenization(text: str) -> str:
    """``transformers``' clean-up of spaces before punctuation and
    contractions."""
    for a, b in ((" .", "."), (" ?", "?"), (" !", "!"), (" ,", ","),
                 (" ' ", "'"), (" n't", "n't"), (" 'm", "'m"),
                 (" 's", "'s"), (" 've", "'ve"), (" 're", "'re")):
        text = text.replace(a, b)
    return text


def _read_json(path: str) -> dict:
    if not os.path.isfile(path):
        return {}
    with open(path, encoding="utf8") as f:
        return json.load(f)


def _content(tok) -> Optional[str]:
    return tok.get("content") if isinstance(tok, dict) else tok


class WhisperTokenizer:
    """``vocab``: byte-level piece -> id; ``added``: added token -> id;
    ``special``: the added (and named) tokens that decoding skips."""

    def __init__(self, vocab: Dict[str, int], added: Dict[str, int],
                 special: Iterable[str], unk_token: Optional[str] = None,
                 clean_up_spaces: bool = False):
        self.vocab = vocab
        self.added = added
        self.id_to_piece = {i: t for t, i in vocab.items()}
        self.id_to_added = {i: t for t, i in added.items()}
        self.special_ids = {self._lookup(t) for t in special} - {None}
        self.unk_token = unk_token
        self.clean_up_spaces = clean_up_spaces
        self.byte_decoder = {c: b for b, c in bytes_to_unicode().items()}

    @classmethod
    def from_pretrained(cls, model_dir: str) -> "WhisperTokenizer":
        join = lambda n: os.path.join(model_dir, n)  # noqa: E731
        cfg = _read_json(join("tokenizer_config.json"))
        special_map = _read_json(join("special_tokens_map.json"))
        added: Dict[str, int] = {}
        special = set()
        if os.path.isfile(join("tokenizer.json")):
            tok = _read_json(join("tokenizer.json"))
            if tok["model"].get("type") != "BPE":
                raise ValueError(f"{model_dir}/tokenizer.json is not a BPE "
                                 f"model")
            vocab = dict(tok["model"]["vocab"])
            for entry in tok.get("added_tokens", []):
                added[entry["content"]] = entry["id"]
                if entry.get("special"):
                    special.add(entry["content"])
        elif os.path.isfile(join("vocab.json")):
            vocab = _read_json(join("vocab.json"))
            added.update(_read_json(join("added_tokens.json")))
        else:
            raise FileNotFoundError(f"no tokenizer.json or vocab.json in "
                                    f"{model_dir}")
        for i, entry in cfg.get("added_tokens_decoder", {}).items():
            added.setdefault(entry["content"], int(i))
            if entry.get("special"):
                special.add(entry["content"])
        for source in (special_map, cfg):
            for key in _SPECIAL_KEYS:
                if _content(source.get(key)):
                    special.add(_content(source[key]))
            for tok in source.get("additional_special_tokens") or []:
                special.add(_content(tok))
        unk = _content(cfg.get("unk_token")) or _content(
            special_map.get("unk_token"))
        return cls(vocab, added, special, unk,
                   bool(cfg.get("clean_up_tokenization_spaces", False)))

    def _lookup(self, token: str) -> Optional[int]:
        if token in self.added:
            return self.added[token]
        return self.vocab.get(token)

    def convert_tokens_to_ids(self, token: str) -> Optional[int]:
        """The token's id; the unknown token's id (None without one) for a
        token the vocabulary does not hold."""
        tid = self._lookup(token)
        if tid is None and self.unk_token is not None:
            return self._lookup(self.unk_token)
        return tid

    def _pieces_to_text(self, pieces: List[str]) -> str:
        data = bytearray(self.byte_decoder[c] for c in "".join(pieces))
        return data.decode("utf-8", errors="replace")

    def decode(self, ids: Iterable[int], skip_special_tokens: bool = True
               ) -> str:
        ids = [int(i) for i in ids]
        if skip_special_tokens and ids:
            prev = self._lookup("<|startofprev|>")
            sot = self._lookup("<|startoftranscript|>")
            if ids[0] == prev:
                ids = ids[ids.index(sot):] if sot in ids else []
        texts: List[str] = []
        run: List[str] = []
        for i in ids:
            if skip_special_tokens and i in self.special_ids:
                continue
            if i in self.id_to_added:
                if run:
                    texts.append(self._pieces_to_text(run))
                    run = []
                texts.append(self.id_to_added[i])
            elif i in self.id_to_piece:
                run.append(self.id_to_piece[i])
        if run:
            texts.append(self._pieces_to_text(run))
        text = "".join(texts)
        if self.clean_up_spaces:
            text = clean_up_tokenization(text)
        return _TIMESTAMP.sub("", text)
