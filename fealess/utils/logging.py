"""Structured logging (the LOGD macro equivalent, linemod/linemod.hpp:10-22).

The reference logs with a printf macro (Android logcat variant behind the
misspelled ``ANDOIRD_LOG`` define) plus unconditional cout chatter in the
ICP loop (ICP/ICP.cpp:342,491,590-592).  Here: standard ``logging`` with a
single package-level logger, quiet by default, and an env override
``FEALESS_LOG=DEBUG`` for field debugging.
"""

from __future__ import annotations

import logging
import os

_CONFIGURED = False


def get_logger(name: str = "fealess") -> logging.Logger:
    global _CONFIGURED
    logger = logging.getLogger(name)
    if not _CONFIGURED:
        level = os.environ.get("FEALESS_LOG", "WARNING").upper()
        handler = logging.StreamHandler()
        handler.setFormatter(logging.Formatter(
            "%(asctime)s %(name)s %(levelname)s: %(message)s"))
        root = logging.getLogger("fealess")
        root.addHandler(handler)
        root.setLevel(getattr(logging, level, logging.WARNING))
        _CONFIGURED = True
    return logger
