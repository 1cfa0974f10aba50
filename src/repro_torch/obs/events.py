"""The frozen event registry (the port's copy of ``repro.obs.events``: the
same types, fields and wire names): every telemetry record is one of these
types.

Each event is an immutable dataclass whose first field ``t`` is the trace
clock in **hours** on the emitting subsystem's timeline (wall-clock hours
for the orchestrator, trace hours for the fleet/simulator, step index for
the decode engine). Within one run the recorder stamps a global
append-order sequence number, so ``t`` only needs to be monotone per
track, not globally.

Events carry *plain data only* (ints, floats, strings, tuples) so a JSONL
round-trip through :mod:`repro_torch.obs.export` is lossless: Python's ``json``
writes shortest-round-trip floats, which re-read bit-exactly — the
property the replay oracle relies on.

The registry (`EVENT_TYPES`) maps the snake_case wire name of each event
to its class. repro-lint rule O001 enforces that instrumented modules
only ever emit these types — no ad-hoc dict events.
"""
from __future__ import annotations

import dataclasses
import re
from dataclasses import dataclass
from typing import Dict, Optional, Tuple, Type

# -- run framing -------------------------------------------------------------


@dataclass(frozen=True)
class RunStart:
    """Opens one replayable unit: everything until the next RunStart."""

    t: float
    subsystem: str  # "orchestrator" | "simulator" | "fleet"
    label: str  # policy / sizing mode, e.g. "siwoft", "static", "auto"
    horizon_hours: float


@dataclass(frozen=True)
class PriceTrace:
    """The price matrix the run billed against, row per market."""

    t: float
    prices: Tuple[Tuple[float, ...], ...]


@dataclass(frozen=True)
class RunEnd:
    t: float
    wall_hours: float


# -- provisioning lifecycle --------------------------------------------------


@dataclass(frozen=True)
class Provision:
    t: float
    market_id: int  # primary (first) leg
    legs: Tuple[int, ...]
    replica_id: int = -1  # serving only; -1 for training/sim
    rate_tokens_per_sec: float = 0.0


@dataclass(frozen=True)
class Revoke:
    t: float
    market_id: int
    replica_id: int = -1


@dataclass(frozen=True)
class ReshardStart:
    t: float
    bytes_moved: int
    gbps: float = 0.0  # 0.0 when the emitter only knows the wire time


@dataclass(frozen=True)
class ReshardDone:
    t: float
    hours: float


# -- autoscaler decisions ----------------------------------------------------


@dataclass(frozen=True)
class ScaleDecision:
    """What the scaler saw when it decided: its full input vector."""

    t: float
    kind: str  # "hold" | "up" | "down"
    offered_tokens_per_sec: float
    forecast_tokens_per_sec: float
    capacity_tokens_per_sec: float
    target_tokens_per_sec: float


@dataclass(frozen=True)
class ScaleUp:
    t: float
    added: int
    target_tokens_per_sec: float


@dataclass(frozen=True)
class ScaleDown:
    t: float
    retired: int
    target_tokens_per_sec: float


# -- decode-engine lane events (t = step index) ------------------------------


@dataclass(frozen=True)
class Admit:
    t: float
    request_id: int
    lane: int
    pages_reserved: int


@dataclass(frozen=True)
class Evict:
    t: float
    request_id: int
    lane: int
    reason: str  # "eos" | "length" | "shed"


@dataclass(frozen=True)
class Shed:
    """Carries everything needed to re-prefill the request elsewhere."""

    t: float
    request_id: int
    lane: int
    prompt_tokens: int
    resume_tokens: int  # tokens generated before the shed


@dataclass(frozen=True)
class Drain:
    t: float
    moved_requests: int


@dataclass(frozen=True)
class GaugeSample:
    t: float
    name: str
    value: float


# -- billing (the replay oracle's inputs) ------------------------------------


@dataclass(frozen=True)
class SessionBilled:
    """A Session handed to ``bill_session``, verbatim.

    ``price_const`` of ``None`` means the run's PriceTrace matrix priced
    this session; a float means a constant price (on-demand reference).
    """

    t: float
    market_id: int
    start_wall: float
    intervals: Tuple[Tuple[str, float], ...]
    legs: Tuple[int, ...]
    leg_anchors: Optional[Tuple[float, ...]] = None
    leg_releases: Optional[Tuple[bool, ...]] = None
    price_const: Optional[float] = None


@dataclass(frozen=True)
class LegSettled:
    """A carried anchor settled via ``settle_leg`` outside any session."""

    t: float
    market_id: int
    anchor: float
    end_wall: float


@dataclass(frozen=True)
class RouterInterval:
    """One closed-form drain interval: the six RouterStats scalars."""

    t: float
    t0: float
    t1: float
    offered_tokens: float
    served_tokens: float
    shed_tokens: float
    queued_token_seconds: float
    slo_violation_seconds: float
    q_end: float
    delay_segments: Tuple[Tuple[float, float, float], ...]


@dataclass(frozen=True)
class SloViolation:
    t: float
    seconds: float


@dataclass(frozen=True)
class BreakdownPin:
    """The run's own Breakdown, recorded at return: replay's expected side."""

    t: float
    time: Tuple[Tuple[str, float], ...]
    cost: Tuple[Tuple[str, float], ...]
    leg_cost: Tuple[Tuple[int, float], ...]
    revocations: int
    sessions: int
    wall_time: float
    served_tokens: float
    shed_tokens: float
    queued_token_seconds: float


# -- registry ----------------------------------------------------------------

_CAMEL = re.compile(r"(?<!^)(?=[A-Z])")


def wire_name(cls: type) -> str:
    """``ReshardStart`` → ``"reshard_start"``: the JSONL ``type`` tag."""
    return _CAMEL.sub("_", cls.__name__).lower()


EVENT_TYPES: Dict[str, Type] = {
    wire_name(cls): cls
    for cls in (
        RunStart,
        PriceTrace,
        RunEnd,
        Provision,
        Revoke,
        ReshardStart,
        ReshardDone,
        ScaleDecision,
        ScaleUp,
        ScaleDown,
        Admit,
        Evict,
        Shed,
        Drain,
        GaugeSample,
        SessionBilled,
        LegSettled,
        RouterInterval,
        SloViolation,
        BreakdownPin,
    )
}


def as_dict(event) -> dict:
    """Event → JSON-ready dict with its wire name under ``"type"``."""
    d = {"type": wire_name(type(event))}
    d.update(dataclasses.asdict(event))
    return d


def _tuplize(value):
    if isinstance(value, list):
        return tuple(_tuplize(v) for v in value)
    return value


def from_dict(d: dict):
    """Inverse of :func:`as_dict`: rebuild the typed event.

    JSON turns tuples into lists; every sequence field is declared as a
    tuple, so lists are converted back wholesale. Unknown keys (from a
    newer schema) are rejected loudly rather than dropped.
    """
    payload = dict(d)
    cls = EVENT_TYPES[payload.pop("type")]
    return cls(**{k: _tuplize(v) for k, v in payload.items()})


# -- emission helpers (registry-typed constructors for the fat events) -------


def price_trace(t: float, prices) -> PriceTrace:
    """Snapshot a ``(n_markets, n_hours)`` price matrix (any ``.tolist()``
    carrier: ndarray or nested sequence)."""
    return PriceTrace(t=t, prices=tuple(tuple(row) for row in prices.tolist()))


def session_billed(t: float, session, price_const: Optional[float] = None) -> SessionBilled:
    """Snapshot a ``repro.core.accounting.Session`` verbatim, at the moment
    it is handed to ``bill_session``."""
    return SessionBilled(
        t=t,
        market_id=int(session.market_id),
        start_wall=session.start_wall,
        intervals=tuple(session.intervals),
        legs=tuple(int(leg) for leg in session.legs),
        leg_anchors=None if session.leg_anchors is None else tuple(session.leg_anchors),
        leg_releases=None if session.leg_releases is None else tuple(session.leg_releases),
        price_const=price_const,
    )


def breakdown_pin(t: float, bd) -> BreakdownPin:
    """Snapshot a ``Breakdown`` as the run's expected replay result."""
    return BreakdownPin(
        t=t,
        time=tuple(bd.time.items()),
        cost=tuple(bd.cost.items()),
        leg_cost=tuple(sorted((int(m), c) for m, c in bd.leg_cost.items())),
        revocations=bd.revocations,
        sessions=bd.sessions,
        wall_time=bd.wall_time,
        served_tokens=bd.served_tokens,
        shed_tokens=bd.shed_tokens,
        queued_token_seconds=bd.queued_token_seconds,
    )


def router_interval(t: float, t0: float, t1: float, stats) -> RouterInterval:
    """Snapshot one ``drain_interval`` result (a ``RouterStats``)."""
    return RouterInterval(
        t=t,
        t0=t0,
        t1=t1,
        offered_tokens=stats.offered_tokens,
        served_tokens=stats.served_tokens,
        shed_tokens=stats.shed_tokens,
        queued_token_seconds=stats.queued_token_seconds,
        slo_violation_seconds=stats.slo_violation_seconds,
        q_end=stats.q_end,
        delay_segments=tuple(tuple(s) for s in stats.delay_segments),
    )
