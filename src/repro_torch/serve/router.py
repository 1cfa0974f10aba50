"""Deterministic open-loop request router for a serving fleet (the port's
copy of ``repro.serve.router``; only its imports differ).

The router is the DEMAND side of the serving subsystem: an open-loop
request trace (tokens/sec offered per wall interval — requests never slow
down because the fleet is struggling, which is what makes the accounting
honest) drains through whatever aggregate capacity the live replicas
provide. Everything is closed-form over piecewise-constant intervals, so
the same trace always produces bit-identical token and SLO accounting —
the serving analogue of the seeded price traces the batch simulator runs
on.

Queue model over one interval of ``seconds`` with constant offered rate
``a`` (tokens/s) and constant fleet capacity ``c`` (tokens/s):

* the backlog evolves linearly, ``q(t) = q0 + (a - c)·t``, floored at 0;
* **SLO violation** — the estimated queueing delay is ``q(t) / c``; every
  second where it exceeds ``max_delay_seconds`` is an SLO-violation
  second (capacity 0 with any demand is a violation outright). The
  crossing times of the linear backlog are solved exactly.
* **shedding** — clients abandon after ``shed_delay_seconds``: the
  backlog is capped at ``c × shed_delay`` and every token that would
  grow it past the cap is shed (with zero capacity the cap is zero —
  everything offered is shed). Shed tokens are *lost demand*, the
  serving analogue of the batch simulator's lost work.
* **queued token·seconds** — the exact integral of the backlog over the
  interval (trapezoids between crossing points), the Little's-law
  numerator for mean latency.

Token conservation holds exactly per interval and is pinned by tests:
``q0 + offered == served + shed + q_end``.

* **latency percentiles** — every linear backlog segment also records the
  estimated delay ``d(t) = q(t)/c`` seen by tokens *arriving* during it,
  as a ``(token_weight, d_start, d_end)`` triple. Arrivals are uniform in
  time, so within a segment the delay is uniform on ``[d_start, d_end]``
  (an atom when the backlog is flat). ``RouterStats.latency_percentile``
  inverts the resulting piecewise-linear CDF exactly — p50/p99 come from
  the same closed-form segments as the violation clock, never from
  sampling. Shed tokens carry no weight (they are lost demand, not a
  latency sample), and a zero-capacity interval contributes violation
  seconds but no finite delay sample.

The counters land on :class:`repro_torch.core.accounting.Breakdown` as
first-class components: the violation clock in ``time["slo_violation"]``,
the token volumes in ``served_tokens`` / ``shed_tokens`` /
``queued_token_seconds``. Percentiles stay on :class:`RouterStats` (they
are diagnostics over the same conserved tokens, not a new component).
"""
from __future__ import annotations

import dataclasses
from typing import Iterable, List, Optional, Sequence, Tuple

import numpy as np

from repro_torch.core.accounting import Breakdown
from repro_torch.core.units import SECONDS_PER_HOUR
from repro_torch.obs import events as obs_ev
from repro_torch.obs.recorder import current as obs_current


@dataclasses.dataclass
class RouterStats:
    """Token/SLO accounting over routed intervals (all exact sums)."""

    offered_tokens: float = 0.0
    served_tokens: float = 0.0
    shed_tokens: float = 0.0
    queued_token_seconds: float = 0.0
    slo_violation_seconds: float = 0.0
    #: backlog (tokens) left at the end of the routed span — the ``q_end``
    #: term of the conservation identity ``q0 + offered == served + shed
    #: + q_end``.
    q_end: float = 0.0
    #: ``(token_weight, delay_start_s, delay_end_s)`` per linear backlog
    #: segment: the estimated delay seen by tokens arriving during the
    #: segment, weighted by how many arrived (shed tokens excluded).
    delay_segments: List[Tuple[float, float, float]] = dataclasses.field(
        default_factory=list
    )

    def add(self, other: "RouterStats") -> "RouterStats":
        self.offered_tokens += other.offered_tokens
        self.served_tokens += other.served_tokens
        self.shed_tokens += other.shed_tokens
        self.queued_token_seconds += other.queued_token_seconds
        self.slo_violation_seconds += other.slo_violation_seconds
        # ``other`` is the later span: its backlog is the running backlog
        self.q_end = other.q_end
        self.delay_segments.extend(other.delay_segments)
        return self

    def latency_percentile(self, frac: float) -> float:
        """Invert the exact token-weighted delay CDF at ``frac`` ∈ [0, 1].

        Each segment spreads its token weight uniformly over
        ``[d_start, d_end]`` (delay is linear in time, arrivals uniform in
        time); a flat segment is an atom. The CDF is piecewise linear with
        jumps at atoms, and the inversion is exact — no sampling, no
        interpolation error beyond float arithmetic. Returns 0.0 when no
        tokens carried a delay sample.
        """
        segs = [
            (min(d0, d1), max(d0, d1), w)
            for (w, d0, d1) in self.delay_segments
            if w > 0.0
        ]
        if not segs:
            return 0.0
        total = sum(w for _, _, w in segs)
        target = min(max(float(frac), 0.0), 1.0) * total

        def cdf(d: float) -> float:
            mass = 0.0
            for lo, hi, w in segs:
                if hi <= lo:
                    mass += w if d >= lo else 0.0
                else:
                    mass += w * min(max((d - lo) / (hi - lo), 0.0), 1.0)
            return mass

        points = sorted({p for lo, hi, _ in segs for p in (lo, hi)})
        prev, prev_mass = points[0], cdf(points[0])
        if prev_mass >= target:
            return prev
        for point in points[1:]:
            mass = cdf(point)
            if mass >= target:
                slope = sum(
                    w / (hi - lo)
                    for lo, hi, w in segs
                    if hi > lo and lo <= prev and point <= hi
                )
                if slope <= 0.0:
                    return point  # target sits inside an atom's jump
                return min(prev + (target - prev_mass) / slope, point)
            prev, prev_mass = point, mass
        return points[-1]

    @property
    def p50_delay_seconds(self) -> float:
        return self.latency_percentile(0.50)

    @property
    def p99_delay_seconds(self) -> float:
        return self.latency_percentile(0.99)

    def merge_into(self, bd: Breakdown) -> None:
        """Land the counters on the shared Breakdown: the violation clock
        as a first-class time component (hours, like every other clock),
        the token volumes on the serving counter fields."""
        bd.time["slo_violation"] += self.slo_violation_seconds / SECONDS_PER_HOUR
        bd.served_tokens += self.served_tokens
        bd.shed_tokens += self.shed_tokens
        bd.queued_token_seconds += self.queued_token_seconds


def drain_interval(
    queue_tokens: float,
    offered_tokens_per_sec: float,
    capacity_tokens_per_sec: float,
    seconds: float,
    *,
    max_delay_seconds: float,
    shed_delay_seconds: float,
) -> Tuple[float, RouterStats]:
    """Route one piecewise-constant interval; returns (backlog after,
    stats). Closed form — no time discretization, so interval splitting is
    associative: routing [0, T] equals routing [0, s] then [s, T].
    """
    a = max(float(offered_tokens_per_sec), 0.0)
    c = max(float(capacity_tokens_per_sec), 0.0)
    T = float(seconds)
    q0 = max(float(queue_tokens), 0.0)
    if T <= 0:
        return q0, RouterStats(q_end=q0)
    stats = RouterStats(offered_tokens=a * T)

    cap = c * float(shed_delay_seconds)
    slo_q = c * float(max_delay_seconds)

    # tokens already waiting past the abandonment bound shed immediately
    # (capacity just dropped under the backlog's feet)
    q = min(q0, cap)
    stats.shed_tokens += q0 - q

    if c <= 0.0:
        # no live capacity: cap is 0, every offered token sheds, and any
        # demand at all is out-of-SLO for the whole interval
        stats.shed_tokens += a * T
        if a > 0.0 or q0 > 0.0:
            stats.slo_violation_seconds += T
        return 0.0, stats

    net = a - c
    if net > 0.0 and q + net * T > cap:
        # backlog hits the abandonment cap at t_cap and rides it, shedding
        # the net inflow from then on; only the admitted rate (c) of the
        # cap-riding arrivals carries latency weight
        t_cap = (cap - q) / net
        stats.shed_tokens += net * (T - t_cap)
        pre = _linear_segments(q, net, t_cap)
        segs = pre + [(T - t_cap, cap, cap)]
        weights = [a * dur for dur, _, _ in pre] + [c * (T - t_cap)]
    else:
        segs = _linear_segments(q, net, T)
        weights = [a * dur for dur, _, _ in segs]

    q_end = segs[-1][2]
    for (dur, qa, qb), w in zip(segs, weights):
        stats.queued_token_seconds += 0.5 * (qa + qb) * dur
        stats.slo_violation_seconds += _time_above(qa, qb, dur, slo_q)
        if w > 0.0:
            stats.delay_segments.append((w, qa / c, qb / c))
    # conservation: served = inflow - shed - backlog growth (exact)
    stats.served_tokens = q0 + a * T - stats.shed_tokens - q_end
    stats.q_end = q_end
    return q_end, stats


def _linear_segments(
    q0: float, net: float, T: float
) -> List[Tuple[float, float, float]]:
    """Split a linear backlog q(t) = q0 + net·t (floored at 0) over [0, T]
    into (duration, q_start, q_end) pieces where it is exactly linear."""
    if T <= 0:
        return [(0.0, q0, q0)]
    if net < 0.0 and q0 + net * T < 0.0:
        t_empty = q0 / -net
        return [(t_empty, q0, 0.0), (T - t_empty, 0.0, 0.0)]
    return [(T, q0, q0 + net * T)]


def _time_above(qa: float, qb: float, dur: float, threshold: float) -> float:
    """Seconds a linear segment from qa to qb (over ``dur`` s) spends
    strictly above ``threshold``."""
    if dur <= 0:
        return 0.0
    above_a, above_b = qa > threshold, qb > threshold
    if above_a and above_b:
        return dur
    if not above_a and not above_b:
        return 0.0
    t_cross = dur * (threshold - qa) / (qb - qa)
    return dur - t_cross if above_b else t_cross


@dataclasses.dataclass(frozen=True)
class CapacityEvent:
    """Fleet capacity from ``at_hours`` (wall) onward, tokens/sec."""

    at_hours: float
    tokens_per_sec: float


def route_trace(
    rate_tokens_per_sec: Sequence[float],
    capacity_events: Iterable[CapacityEvent],
    *,
    max_delay_seconds: float,
    shed_delay_seconds: float,
    hours: Optional[float] = None,
) -> RouterStats:
    """Drain an hourly offered-rate trace through a piecewise-constant
    capacity timeline. ``rate_tokens_per_sec[h]`` is the offered rate over
    wall hour ``[h, h+1)``; ``capacity_events`` is a sorted (by time)
    sequence of capacity changes, the first at hour 0. Intervals are split
    at every hour mark and capacity change — closed-form inside each.
    """
    events = sorted(capacity_events, key=lambda e: e.at_hours)
    assert events and events[0].at_hours <= 0.0, "capacity at t=0 required"
    end = float(hours if hours is not None else len(rate_tokens_per_sec))
    # hoist the per-interval element conversions out of the walk: one
    # float array instead of a Sequence __getitem__ + float() per interval
    rate = np.asarray(rate_tokens_per_sec, dtype=float)
    # all boundaries: hour marks + event times
    marks = sorted(
        {float(h) for h in range(int(end) + 1)}
        | {e.at_hours for e in events if 0.0 < e.at_hours < end}
        | {end}
    )
    cap_i = 0
    stats = RouterStats()
    q = 0.0
    rec = obs_current()
    for t0, t1 in zip(marks, marks[1:]):
        if t1 <= t0:
            continue
        while cap_i + 1 < len(events) and events[cap_i + 1].at_hours <= t0 + 1e-12:
            cap_i += 1
        rate_idx = min(int(t0), rate.size - 1)
        q, s = drain_interval(
            q,
            float(rate[rate_idx]),
            events[cap_i].tokens_per_sec,
            (t1 - t0) * SECONDS_PER_HOUR,
            max_delay_seconds=max_delay_seconds,
            shed_delay_seconds=shed_delay_seconds,
        )
        if rec.enabled:
            # one event per closed-form interval: replay re-folds these
            # through RouterStats.add in the same order, so the merged
            # totals land on the Breakdown bit-exactly
            rec.emit(obs_ev.router_interval(t0, t0, t1, s))
            if s.slo_violation_seconds > 0.0:
                rec.emit(obs_ev.SloViolation(t=t0, seconds=s.slo_violation_seconds))
        stats.add(s)
    return stats


def idle_headroom_tokens(
    rate_tokens_per_sec: Sequence[float],
    capacity_events: Iterable[CapacityEvent],
    *,
    hours: Optional[float] = None,
) -> float:
    """Tokens of provisioned capacity the offered trace never used:
    ``∫ max(capacity(t) − offered(t), 0) dt`` over the window, walking the
    exact hour-mark/event-time boundaries of :func:`route_trace`. This is
    the over-provisioning the demand-driven autoscaler exists to shed —
    a statically peak-sized fleet burns it all night."""
    events = sorted(capacity_events, key=lambda e: e.at_hours)
    assert events and events[0].at_hours <= 0.0, "capacity at t=0 required"
    end = float(hours if hours is not None else len(rate_tokens_per_sec))
    rate = np.asarray(rate_tokens_per_sec, dtype=float)
    marks = sorted(
        {float(h) for h in range(int(end) + 1)}
        | {e.at_hours for e in events if 0.0 < e.at_hours < end}
        | {end}
    )
    cap_i = 0
    idle = 0.0
    for t0, t1 in zip(marks, marks[1:]):
        if t1 <= t0:
            continue
        while cap_i + 1 < len(events) and events[cap_i + 1].at_hours <= t0 + 1e-12:
            cap_i += 1
        rate_idx = min(int(t0), rate.size - 1)
        headroom = events[cap_i].tokens_per_sec - float(rate[rate_idx])
        if headroom > 0.0:
            idle += headroom * (t1 - t0) * SECONDS_PER_HOUR
    return idle
