"""Leveled logging (port of arkoserenderer_tpu/core/logging.py).

Every logger hangs under the "arkose_torch" root, which writes to stderr at
the level of ``ARKOSE_TORCH_LOG_LEVEL`` (default INFO) and counts the
warnings and errors, so a tool can report them.
"""

from __future__ import annotations

import logging
import os
import sys

_COUNTS = {"warning": 0, "error": 0}


class _CountingHandler(logging.Handler):
    def emit(self, record: logging.LogRecord) -> None:
        if record.levelno >= logging.ERROR:
            _COUNTS["error"] += 1
        elif record.levelno >= logging.WARNING:
            _COUNTS["warning"] += 1


_root = logging.getLogger("arkose_torch")
_root.setLevel(os.environ.get("ARKOSE_TORCH_LOG_LEVEL", "INFO").upper())
_handler = logging.StreamHandler(sys.stderr)
_handler.setFormatter(logging.Formatter("[%(levelname).1s] %(name)s: %(message)s"))
_root.addHandler(_handler)
_root.addHandler(_CountingHandler())
_root.propagate = False


def get_logger(name: str = "") -> logging.Logger:
    return _root.getChild(name) if name else _root


def warning_count() -> int:
    return _COUNTS["warning"]


def error_count() -> int:
    return _COUNTS["error"]
