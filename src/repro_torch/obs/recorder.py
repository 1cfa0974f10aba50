"""Recorders: where events go, and the null default that makes them free.

The module-level *current recorder* is what instrumented code consults.
It defaults to a :class:`NullRecorder` whose ``enabled`` attribute is
``False``; every instrumentation site reads the recorder once per
run/function and guards each emission with ``if rec.enabled:`` — with
telemetry off no event object is ever constructed and no arithmetic
changes, so every pinned bit-exact path stays byte-identical.

Enable telemetry for a scope with::

    from repro_torch import obs

    with obs.recording() as rec:
        fleet.run()
    rec.events  # the typed timeline, in emission order
"""
from __future__ import annotations

from contextlib import contextmanager
from typing import Dict, Iterator, List


class Recorder:
    """Append-only in-memory event sink with counters/gauges/histograms.

    ``events`` holds typed event instances in emission order (the global
    order *is* the sequence number — ``events[i]`` was the i-th emit).
    Counters/gauges/histograms are side telemetry and never participate
    in the replay oracle.
    """

    enabled = True

    def __init__(self) -> None:
        self.events: List[object] = []
        self.counters: Dict[str, int] = {}
        self.gauge_values: Dict[str, float] = {}
        self.gauge_series: Dict[str, List[tuple]] = {}
        self.histograms: Dict[str, List[float]] = {}

    def emit(self, event) -> None:
        self.events.append(event)

    def count(self, name: str, delta: int = 1) -> None:
        self.counters[name] = self.counters.get(name, 0) + delta

    def gauge(self, name: str, t: float, value: float) -> None:
        self.gauge_values[name] = value
        self.gauge_series.setdefault(name, []).append((t, value))

    def observe(self, name: str, value: float) -> None:
        self.histograms.setdefault(name, []).append(value)

    def clear(self) -> None:
        self.events.clear()
        self.counters.clear()
        self.gauge_values.clear()
        self.gauge_series.clear()
        self.histograms.clear()


class NullRecorder:
    """The default sink: ``enabled`` is False, every method is a no-op.

    Instrumented code never calls these when it honours the
    ``if rec.enabled:`` guard; they exist so unguarded calls still work.
    """

    enabled = False

    def emit(self, event) -> None:  # pragma: no cover - guarded out
        pass

    def count(self, name: str, delta: int = 1) -> None:  # pragma: no cover
        pass

    def gauge(self, name: str, t: float, value: float) -> None:  # pragma: no cover
        pass

    def observe(self, name: str, value: float) -> None:  # pragma: no cover
        pass


_NULL = NullRecorder()
_current = _NULL


def current():
    """The active recorder: consult once per run, guard on ``.enabled``."""
    return _current


def set_current(recorder) -> None:
    global _current
    _current = recorder if recorder is not None else _NULL


@contextmanager
def recording(recorder: Recorder | None = None) -> Iterator[Recorder]:
    """Install ``recorder`` (a fresh one by default) for the with-block."""
    rec = recorder if recorder is not None else Recorder()
    prev = _current
    set_current(rec)
    try:
        yield rec
    finally:
        set_current(prev)
