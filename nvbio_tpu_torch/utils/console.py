"""Leveled stderr logging (parity with ``nvbio/basic/console.h:44-57``).

A copy of ``nvbio_tpu.utils.console``.
"""

from __future__ import annotations

import sys
import time

LEVELS = {"error": 0, "visible": 1, "info": 2, "stats": 3, "verbose": 4, "debug": 5}
_verbosity = 3


def set_verbosity(level: str | int) -> None:
    global _verbosity
    _verbosity = LEVELS.get(level, level) if isinstance(level, str) else int(level)


def _log(level: str, msg: str) -> None:
    if LEVELS[level] <= _verbosity:
        ts = time.strftime("%H:%M:%S")
        sys.stderr.write(f"[{ts} {level:>7}] {msg}\n")
        sys.stderr.flush()


def log_error(msg: str) -> None:
    _log("error", msg)


def log_visible(msg: str) -> None:
    _log("visible", msg)


def log_info(msg: str) -> None:
    _log("info", msg)


def log_stats(msg: str) -> None:
    _log("stats", msg)


def log_verbose(msg: str) -> None:
    _log("verbose", msg)


def log_debug(msg: str) -> None:
    _log("debug", msg)
