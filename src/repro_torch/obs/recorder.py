"""Recorders (the port's copy of ``repro.obs.recorder``): where events
go, and the null default that makes them free.

Instrumented code reads ``current()`` once and guards every emission with
``if rec.enabled:``; with telemetry off no event is ever built. Enable it
for a scope with ``with recording() as rec: ...``.
"""
from __future__ import annotations

from contextlib import contextmanager
from typing import Dict, Iterator, List


class Recorder:
    """Append-only in-memory event sink with gauges."""

    enabled = True

    def __init__(self) -> None:
        self.events: List[object] = []
        self.gauge_values: Dict[str, float] = {}
        self.gauge_series: Dict[str, List[tuple]] = {}

    def emit(self, event) -> None:
        self.events.append(event)

    def gauge(self, name: str, t: float, value: float) -> None:
        self.gauge_values[name] = value
        self.gauge_series.setdefault(name, []).append((t, value))


class NullRecorder:
    """The default sink: ``enabled`` is False, every method is a no-op."""

    enabled = False

    def emit(self, event) -> None:  # pragma: no cover - guarded out
        pass

    def gauge(self, name: str, t: float, value: float) -> None:  # pragma: no cover
        pass


_NULL = NullRecorder()
_current = _NULL


def current():
    """The active recorder: consult once per run, guard on ``.enabled``."""
    return _current


@contextmanager
def recording(recorder: Recorder | None = None) -> Iterator[Recorder]:
    """Install ``recorder`` (a fresh one by default) for the with-block."""
    global _current
    rec = recorder if recorder is not None else Recorder()
    prev = _current
    _current = rec
    try:
        yield rec
    finally:
        _current = prev
