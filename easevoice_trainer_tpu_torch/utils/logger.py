"""Stdlib logger with an EASEVOICE_LOG_LEVEL env switch.

Mirrors the reference logging contract (reference: src/logger/__init__.py:5-22).
"""
from __future__ import annotations

import logging
import os
import sys

_FORMAT = "%(asctime)s [%(levelname)s] %(name)s: %(message)s"


def get_logger(name: str = "easevoice") -> logging.Logger:
    log = logging.getLogger(name)
    if not log.handlers:
        handler = logging.StreamHandler(sys.stderr)
        handler.setFormatter(logging.Formatter(_FORMAT))
        log.addHandler(handler)
        level = os.environ.get("EASEVOICE_LOG_LEVEL", "INFO").upper()
        log.setLevel(getattr(logging, level, logging.INFO))
        log.propagate = False
    return log


logger = get_logger()
