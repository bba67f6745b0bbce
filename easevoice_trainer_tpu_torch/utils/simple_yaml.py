"""A reader for the YAML subset of the repo's ``configs/gpt.yaml`` and of
FunASR's ``config.yaml`` files (Paraformer, fsmn-VAD, CT-punc), for hosts
without PyYAML.

The subset: block mappings nested to any depth, block sequences (``- x``
items, at the key's indentation or deeper, nested ones written ``- - x`` or
on their own lines, items that are mappings), flow sequences of scalars
(``[0, 1]``, ``[]``), the empty flow mapping ``{}``, ``#`` comments and
blank lines; the document is a mapping.  Scalars are resolved as PyYAML's
``safe_load`` resolves them (YAML 1.1): null, booleans, decimal integers,
floats with a dot or ``.inf`` / ``.nan``, quoted strings, and plain strings
otherwise.  Anything else (nested flow collections, flow mappings with
entries, anchors, block scalars, multi-line scalars, tabs, duplicate keys,
ragged indentation) raises ``ValueError`` rather than being read another way
than PyYAML would read it.
"""
from __future__ import annotations

import re
from typing import Any, Dict, List, Tuple

_BOOL = {**{w: True for w in ("yes", "Yes", "YES", "true", "True", "TRUE",
                              "on", "On", "ON")},
         **{w: False for w in ("no", "No", "NO", "false", "False", "FALSE",
                               "off", "Off", "OFF")}}
_NULL = ("", "~", "null", "Null", "NULL")
_INT = re.compile(r"[-+]?(?:0|[1-9][0-9_]*)$")
_FLOAT = re.compile(r"[-+]?(?:[0-9][0-9_]*)\.[0-9_]*(?:[eE][-+][0-9]+)?$"
                    r"|\.[0-9][0-9_]*(?:[eE][-+][0-9]+)?$")
_INF = re.compile(r"[-+]?\.(?:inf|Inf|INF)$")
_NAN = re.compile(r"\.(?:nan|NaN|NAN)$")
_KEY = re.compile(r"([A-Za-z_][A-Za-z0-9_.\-]*):(?:\s+(.*))?$")
# numbers PyYAML reads in other bases (binary, octal, hex, base 60)
_OTHER_BASE = re.compile(r"[-+]?0[0-9_bx]|[-+]?[0-9][0-9_]*(?::[0-5]?[0-9])+"
                         r"(?:\.[0-9_]*)?$")
# what a plain scalar of this subset may not start with
_RESERVED = tuple("[]{}&*!|>%@`,") + ("'", '"', "- ", "? ")


def _strip_comment(text: str) -> str:
    """The line without a trailing ``#`` comment (one that starts the line
    or follows whitespace), outside quotes."""
    quote = None
    for i, ch in enumerate(text):
        if quote:
            if ch == quote:
                quote = None
        elif ch in "'\"":
            quote = ch
        elif ch == "#" and (i == 0 or text[i - 1] in " \t"):
            return text[:i].rstrip()
    return text.rstrip()


def scalar(text: str) -> Any:
    """One scalar as PyYAML's safe_load resolves it."""
    t = text.strip()
    if len(t) >= 2 and t[0] == t[-1] == "'":
        return t[1:-1].replace("''", "'")
    if len(t) >= 2 and t[0] == t[-1] == '"':
        body = t[1:-1]
        if "\\" in body:
            raise ValueError(f"escapes in {t!r} are outside the subset")
        return body
    if t in _NULL:
        return None
    if t in _BOOL:
        return _BOOL[t]
    if (t.startswith(_RESERVED) or t in ("-", "?") or ": " in t
            or t.endswith(":") or " #" in t):
        raise ValueError(f"scalar {t!r} is outside the subset")
    if _OTHER_BASE.match(t) and t not in ("0", "+0", "-0") \
            and not _FLOAT.match(t):
        raise ValueError(f"number {t!r} is outside the subset")
    if _INT.match(t):
        return int(t.replace("_", ""))
    if _FLOAT.match(t):
        return float(t.replace("_", ""))
    if _INF.match(t):
        return float("-inf") if t.startswith("-") else float("inf")
    if _NAN.match(t):
        return float("nan")
    return t


def _flow_items(body: str) -> List[str]:
    """The comma-separated items of a flow sequence's body, split outside
    quotes."""
    items, cur, quote = [], "", None
    for ch in body:
        if quote:
            quote = None if ch == quote else quote
        elif ch in "'\"":
            quote = ch
        elif ch == ",":
            items.append(cur)
            cur = ""
            continue
        cur += ch
    return items + [cur]


def _inline(value: str, n: int) -> Any:
    """A value on its key's (or its ``-``'s) line: a flow sequence of
    scalars, ``{}``, or a scalar."""
    if value.startswith("["):
        if not value.endswith("]"):
            raise ValueError(f"line {n}: flow sequence {value!r} outside "
                             f"the subset")
        body = value[1:-1].strip()
        if not body:
            return []
        out = []
        for item in _flow_items(body):
            item = item.strip()
            if not item or item[0] in "[]{}" or item[-1] in "[]{}":
                raise ValueError(f"line {n}: flow item {item!r} outside "
                                 f"the subset")
            out.append(scalar(item))
        return out
    if value.startswith("{"):
        if value.replace(" ", "") == "{}":
            return {}
        raise ValueError(f"line {n}: flow mappings are outside the subset")
    return scalar(value)


def _is_item(content: str) -> bool:
    return content == "-" or content.startswith("- ")


class _Parser:
    """Recursive descent over (line number, indentation, content) rows."""

    def __init__(self, rows: List[Tuple[int, int, str]]):
        self.rows = rows
        self.i = 0

    def node(self, indent: int) -> Any:
        if _is_item(self.rows[self.i][2]):
            return self.seq(indent)
        return self.mapping(indent)

    def child(self, indent: int, after_key: bool) -> Any:
        """The block under a ``key:`` or a bare ``-`` at ``indent``: the
        rows indented deeper, or (after a key) a sequence at the key's own
        indentation; None when there is nothing."""
        if self.i >= len(self.rows):
            return None
        _, lead, content = self.rows[self.i]
        if lead > indent:
            return self.node(lead)
        if after_key and lead == indent and _is_item(content):
            return self.seq(indent)
        return None

    def mapping(self, indent: int) -> Dict[str, Any]:
        out: Dict[str, Any] = {}
        while self.i < len(self.rows):
            n, lead, content = self.rows[self.i]
            if lead < indent:
                break
            if lead > indent or _is_item(content):
                raise ValueError(f"line {n}: indentation outside the subset")
            m = _KEY.match(content)
            if m is None:
                raise ValueError(f"line {n}: {content!r} is not a 'key: "
                                 f"value' line of the subset")
            key, value = m.group(1), m.group(2)
            if key in out:
                raise ValueError(f"line {n}: duplicate key {key!r}")
            self.i += 1
            out[key] = (_inline(value, n) if value
                        else self.child(indent, after_key=True))
        return out

    def seq(self, indent: int) -> List[Any]:
        out: List[Any] = []
        while self.i < len(self.rows):
            n, lead, content = self.rows[self.i]
            if lead < indent or (lead == indent and not _is_item(content)):
                break
            if lead > indent:
                raise ValueError(f"line {n}: indentation outside the subset")
            rest = content[1:]
            value = rest.lstrip(" ")
            if not value:
                self.i += 1
                out.append(self.child(indent, after_key=False))
            elif _is_item(value) or _KEY.match(value):
                # "- - x" or "- key: v": the item is a block node whose
                # first row starts at the column of its first character
                col = indent + 1 + len(rest) - len(value)
                self.rows[self.i] = (n, col, value)
                out.append(self.node(col))
            else:
                self.i += 1
                out.append(_inline(value, n))
        return out


def loads(text: str) -> Dict[str, Any]:
    """Parse the subset; returns nested dicts and lists."""
    rows: List[Tuple[int, int, str]] = []
    for n, raw in enumerate(text.splitlines(), 1):
        if "\t" in raw:
            raise ValueError(f"line {n}: tabs are outside the subset")
        line = _strip_comment(raw)
        if not line.strip():
            continue
        if line.strip() in ("---", "..."):
            raise ValueError(f"line {n}: documents are outside the subset")
        rows.append((n, len(line) - len(line.lstrip(" ")), line.strip()))
    if not rows:
        return {}
    if _is_item(rows[0][2]):
        raise ValueError("the document must be a mapping")
    parser = _Parser(rows)
    root = parser.mapping(rows[0][1])
    if parser.i != len(rows):
        raise ValueError(f"line {rows[parser.i][0]}: indentation outside "
                         f"the subset")
    return root


def load(path: str) -> Dict[str, Any]:
    with open(path, encoding="utf8") as f:
        return loads(f.read())
