"""A small structured stderr logger for the launchers (the port's copy of
``repro.obs.log``).

stdout stays machine-owned (``PLAN_JSON`` lines, ``SPLIT_JSON``, CSV
rows, roofline tables); human status goes to stderr in one greppable
shape::

    [serve] INFO fleet plan chosen replicas=3 cost_per_hour=1.2750

Levels are ``debug`` < ``info`` < ``warn``; the threshold comes from the
``REPRO_LOG`` environment variable (default ``info``). No timestamps —
launcher output stays deterministic run to run.
"""
from __future__ import annotations

import os
import sys
from typing import Dict

_LEVELS = {"debug": 10, "info": 20, "warn": 30}


def _threshold() -> int:
    return _LEVELS.get(os.environ.get("REPRO_LOG", "info").lower(), 20)


def _format_value(value) -> str:
    if isinstance(value, float):
        return f"{value:.4f}"
    return str(value)


class Logger:
    """Leveled stderr logger with a machine-greppable key=value tail."""

    def __init__(self, name: str) -> None:
        self.name = name

    def _log(self, level: str, message: str, fields: dict) -> None:
        if _LEVELS[level] < _threshold():
            return
        tail = "".join(
            f" {key}={_format_value(value)}" for key, value in fields.items()
        )
        print(
            f"[{self.name}] {level.upper()} {message}{tail}",
            file=sys.stderr,
            flush=True,
        )

    def debug(self, message: str, **fields) -> None:
        self._log("debug", message, fields)

    def info(self, message: str, **fields) -> None:
        self._log("info", message, fields)

    def warn(self, message: str, **fields) -> None:
        self._log("warn", message, fields)


_loggers: Dict[str, Logger] = {}


def get_logger(name: str) -> Logger:
    if name not in _loggers:
        _loggers[name] = Logger(name)
    return _loggers[name]
