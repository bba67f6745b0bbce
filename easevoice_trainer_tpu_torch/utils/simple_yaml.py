"""A reader for the YAML subset of ``configs/gpt.yaml``, for hosts without
PyYAML.

The subset: a block mapping of at most two levels (top-level keys with a
scalar, or with an indented block of ``key: scalar`` lines), ``#`` comments
and blank lines.  Scalars are resolved as PyYAML's ``safe_load`` resolves
them (YAML 1.1): null, booleans, decimal integers, floats with a dot or
``.inf`` / ``.nan``, quoted strings, and plain strings otherwise.  Anything
else (sequences, flow collections, anchors, block scalars, tabs, deeper
nesting, duplicate keys) raises ``ValueError`` rather than being read
another way than PyYAML would read it.
"""
from __future__ import annotations

import re
from typing import Any, Dict

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


def loads(text: str) -> Dict[str, Any]:
    """Parse the subset; returns nested dicts."""
    root: Dict[str, Any] = {}
    block = None       # the open second-level mapping
    block_key = None
    indent = None      # its indentation

    def close():
        if block_key is not None and not root[block_key]:
            root[block_key] = None     # "key:" with nothing under it

    for n, raw in enumerate(text.splitlines(), 1):
        if "\t" in raw:
            raise ValueError(f"line {n}: tabs are outside the subset")
        line = _strip_comment(raw)
        if not line.strip():
            continue
        if line.strip() in ("---", "..."):
            raise ValueError(f"line {n}: documents are outside the subset")
        lead = len(line) - len(line.lstrip(" "))
        m = _KEY.match(line.strip())
        if m is None:
            raise ValueError(f"line {n}: {raw!r} is not a 'key: scalar' "
                             f"line of the subset")
        key, value = m.group(1), m.group(2)
        if lead == 0:
            close()
            if key in root:
                raise ValueError(f"line {n}: duplicate key {key!r}")
            if value is None or value == "":
                block = root[key] = {}
                block_key, indent = key, None
            else:
                root[key] = scalar(value)
                block = block_key = None
            continue
        if block is None or (indent is not None and lead != indent):
            raise ValueError(f"line {n}: indentation outside the subset")
        indent = lead
        if key in block:
            raise ValueError(f"line {n}: duplicate key {key!r}")
        if value is None or value == "":
            raise ValueError(f"line {n}: a third level is outside the "
                             f"subset")
        block[key] = scalar(value)
    close()
    return root


def load(path: str) -> Dict[str, Any]:
    with open(path, encoding="utf8") as f:
        return loads(f.read())
