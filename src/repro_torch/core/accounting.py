"""Completion-time and deployment-cost accounting (paper Fig. 1 structure).

Every simulated job produces a :class:`Breakdown` with the exact stacked
components the paper plots:

time components  : execution, re_execution, checkpointing, recovery,
                   reshard, startup, slo_violation
cost components  : the same seven (time × in-effect spot price) plus
                   billing_buffer — the cost of the unused remainder of each
                   started billing cycle (EC2 bills whole hours; the paper
                   calls these "buffer costs of billing cycles").

``reshard`` (beyond the paper) is the live cross-mesh migration a spot
revocation triggers in siwoft/hybrid modes: bytes actually moved (see
``repro.dist.meshplan.reshard_bytes``) over the destination market's
interconnect. It sits head-to-head with ``recovery`` (checkpoint restore
through remote storage) in Fig-1-style breakdowns, so the "no-FT is
cheaper" comparison is priced in bytes and dollars, not asserted.

``slo_violation`` (beyond the paper, serving) is the wall time a serving
fleet spent out of its latency SLO (``repro.serve.router``); the fleet
simulator adds it to ``Breakdown.time`` directly — it is a penalty clock,
not an occupancy interval, so no session bills dollars against it. The
serving token counters (``served_tokens`` / ``shed_tokens`` /
``queued_token_seconds``) ride on the Breakdown the same way
``revocations`` does: merged by :meth:`Breakdown.add`, zero for batch
jobs.

Leg-level billing-cycle staggering (beyond the paper): by default every
leg of a session starts its billing cycle at the session start and pays
its buffer at the session end ("cycles aligned"). A session may instead
carry per-leg ``leg_anchors`` (the absolute wall hour each leg's cycle
phase is anchored to — its tenure start) and ``leg_releases`` (whether
the leg's occupancy ends with this session). An unreleased leg pays NO
buffer at session end — its cycle continues into the next session that
carries the same anchor — so a mid-cycle one-leg repair bills only the
replaced leg's partial hour; :func:`settle_leg` charges the final partial
cycle of a leg whose tenure ends without a closing session.
"""
from __future__ import annotations

import dataclasses
import math
from typing import Dict, List, Optional, Tuple

import numpy as np

TIME_COMPONENTS = (
    "execution", "re_execution", "checkpointing", "recovery", "reshard", "startup",
    "slo_violation",
)
COST_COMPONENTS = TIME_COMPONENTS + ("billing_buffer",)

BILLING_CYCLE_HOURS = 1.0


@dataclasses.dataclass
class Breakdown:
    time: Dict[str, float] = dataclasses.field(
        default_factory=lambda: {k: 0.0 for k in TIME_COMPONENTS}
    )
    cost: Dict[str, float] = dataclasses.field(
        default_factory=lambda: {k: 0.0 for k in COST_COMPONENTS}
    )
    revocations: int = 0
    sessions: int = 0
    # wall-clock completion time; == total_time for serial policies, less for
    # replication (replicas burn hours in parallel)
    wall_time: float = 0.0
    # per-leg cost: market_id -> $ billed against that market across every
    # session (multi-leg allocations bill each leg at its own spot price;
    # market_id -1 is the on-demand reference). INVARIANT, pinned by
    # tests/test_allocation.py: sum(leg_cost.values()) == total_cost.
    leg_cost: Dict[int, float] = dataclasses.field(default_factory=dict)
    # serving counters (repro.serve.router): tokens the fleet served /
    # shed, and the integral of queued tokens over time (token·seconds).
    # Zero for batch jobs; the SLO-violation CLOCK lands in
    # time["slo_violation"], these carry the matching token volumes.
    served_tokens: float = 0.0
    shed_tokens: float = 0.0
    queued_token_seconds: float = 0.0

    @property
    def total_time(self) -> float:
        return sum(self.time.values())

    @property
    def total_cost(self) -> float:
        return sum(self.cost.values())

    def add_leg_cost(self, market_id: int, dollars: float) -> None:
        self.leg_cost[market_id] = self.leg_cost.get(market_id, 0.0) + dollars

    def add(self, other: "Breakdown") -> "Breakdown":
        for k in self.time:
            self.time[k] += other.time[k]
        for k in self.cost:
            self.cost[k] += other.cost[k]
        for m, c in other.leg_cost.items():
            self.add_leg_cost(m, c)
        self.revocations += other.revocations
        self.sessions += other.sessions
        self.wall_time += other.wall_time
        self.served_tokens += other.served_tokens
        self.shed_tokens += other.shed_tokens
        self.queued_token_seconds += other.queued_token_seconds
        return self


@dataclasses.dataclass
class Session:
    """One continuous occupancy of one *allocation*: a list of (component,
    duration) intervals billed against an hourly price function.

    ``legs`` is the tuple of market ids billing concurrently — one entry
    per allocation leg, each charged at its own spot price for the whole
    session (legs run in lockstep; a leg is occupied for every wall hour
    the job runs, whatever component that hour lands in). Defaults to the
    single-market ``(market_id,)``, which bills identically to the
    pre-allocation accounting.

    ``leg_anchors`` (optional, one per leg) staggers billing cycles: each
    leg's whole-hour cycles are phased from its own anchor — the absolute
    wall hour its tenure began, ≤ ``start_wall`` — instead of the shared
    session start. ``leg_releases`` (optional, one per leg) marks which
    legs' occupancy ENDS with this session; a leg not released pays no
    billing buffer here (its current cycle continues into a later session
    carrying the same anchor, or is settled by :func:`settle_leg`). When
    ``leg_anchors`` is None the legacy aligned-cycle billing applies
    exactly: every leg anchors at the session start and is released at
    the session end."""

    market_id: int
    start_wall: float
    intervals: List[Tuple[str, float]] = dataclasses.field(default_factory=list)
    legs: Optional[Tuple[int, ...]] = None
    leg_anchors: Optional[Tuple[float, ...]] = None
    leg_releases: Optional[Tuple[bool, ...]] = None

    def __post_init__(self):
        if self.legs is None:
            self.legs = (self.market_id,)
        if self.leg_anchors is not None:
            assert len(self.leg_anchors) == len(self.legs)
            assert all(a <= self.start_wall + 1e-12 for a in self.leg_anchors), (
                "a leg's cycle anchor is its tenure start — never after the "
                "session it bills in"
            )
        if self.leg_releases is not None:
            assert len(self.leg_releases) == len(self.legs)

    def add(self, component: str, hours: float) -> None:
        if hours > 0:
            self.intervals.append((component, hours))

    @property
    def used_hours(self) -> float:
        return sum(h for _, h in self.intervals)


class PriceTable:
    """Vectorized ``(market_id, absolute_hour) -> $/h`` price source.

    Wraps a ``(n_markets, n_hours)`` price matrix; calling it reproduces
    the legacy closures (``MarketSet.spot_price`` and the simulators'
    ``_price`` lambdas) exactly, including the clamp of out-of-range hours
    to the final column. Passing a PriceTable — instead of an opaque
    callable — to :func:`bill_session` is what unlocks the vectorized
    billing path: the biller can gather a whole interval's hourly prices
    in one numpy indexing op instead of one Python call per (hour, leg).
    """

    __slots__ = ("prices", "_broadcast")

    def __init__(self, prices: np.ndarray, *, broadcast_market: bool = False):
        self.prices = np.asarray(prices, dtype=float)
        assert self.prices.ndim == 2 and self.prices.shape[1] >= 1
        self._broadcast = broadcast_market

    @classmethod
    def constant(cls, price: float) -> "PriceTable":
        """A flat price for every market and hour (the on-demand case)."""
        return cls(np.array([[float(price)]]), broadcast_market=True)

    def row(self, market_id: int) -> np.ndarray:
        return self.prices[0] if self._broadcast else self.prices[market_id]

    def __call__(self, market_id: int, hour: int) -> float:
        row = self.row(market_id)
        return float(row[min(int(hour), row.shape[0] - 1)])


_EMPTY = np.empty(0)


def _interval_layout(t: float, dur: float) -> Tuple[int, float, int, float, float]:
    """Closed-form replay of the scalar billing loop over ONE interval.

    Returns ``(first_hour, cell0, n_ones, tail, t_after)`` describing the
    exact hour-cell sequence ``[cell0] + [1.0]*n_ones + ([tail] if tail)``
    billed in consecutive wall hours from ``first_hour`` — step-for-step
    identical to the scalar ``while remaining > 1e-12`` loop starting at
    wall time ``t``. A zero-length interval reports ``cell0 == 0.0`` (no
    cells). Exactness argument (the reason no per-hour iteration is
    needed):

    * the first partial step ``(floor(t)+1) - t`` re-adds to exactly the
      next hour boundary, so after it ``t`` is exactly integral;
    * from an integral ``t``, every full cycle decrements ``remaining`` by
      exactly 1.0 (both exact float ops for ``remaining ≥ 1``), so the
      cell list is ``int(remaining)`` ones plus an exact fractional tail;
    * a tail ≤ 1e-12 is NOT billed and does NOT advance ``t`` — the same
      epsilon guard the scalar loop applies.
    """
    remaining = dur
    if not remaining > 1e-12:
        return 0, 0.0, 0, 0.0, t
    first_hour = math.floor(t)
    width = (first_hour + 1) - t
    if remaining <= width:
        return first_hour, remaining, 0, 0.0, t + remaining
    remaining = dur - width
    n_full = int(remaining)
    tail = remaining - n_full
    if tail > 1e-12:
        return first_hour, width, n_full, tail, float(first_hour + 1 + n_full) + tail
    return first_hour, width, n_full, 0.0, float(first_hour + 1 + n_full)


def _interval_cells(t: float, dur: float) -> Tuple[np.ndarray, int, float]:
    """:func:`_interval_layout` materialized as a step array — the form the
    property tests compare against the scalar loop cell-by-cell."""
    first_hour, cell0, n_ones, tail, t_after = _interval_layout(t, dur)
    if cell0 == 0.0:
        return _EMPTY, 0, t_after
    steps = np.ones(1 + n_ones + (1 if tail else 0))
    steps[0] = cell0
    if tail:
        steps[-1] = tail
    return steps, first_hour, t_after


def _fold(start: float, terms: np.ndarray) -> float:
    """Strict left-to-right float accumulation ``start + terms[0] + ...``.

    ``np.add.accumulate`` is sequential for float64 (pairwise summation
    only applies to ``add.reduce``), so this is bit-identical to the
    scalar ``+=`` loop it replaces — the property tests in
    ``tests/test_vectorized_core.py`` pin that equivalence.
    """
    if terms.size == 0:
        return start
    acc = np.empty(terms.size + 1)
    acc[0] = start
    acc[1:] = terms
    return float(np.add.accumulate(acc)[-1])


def bill_session(
    session: Session,
    price_of_hour,  # (market_id, absolute_hour) -> $/h, or a PriceTable
    breakdown: Breakdown,
) -> float:
    """Accrue a session into a breakdown with per-billing-cycle pricing.

    Each component interval is charged at the spot price in effect during
    the wall-clock hour it runs in — summed over the session's legs, each
    leg at its own market's price — and the per-leg shares land in
    ``Breakdown.leg_cost`` so allocation bills decompose exactly. The
    unused tail of the final billing cycle (per leg: whole-hour billing is
    per spot request) is charged to ``billing_buffer``. With staggered
    ``leg_anchors``, each RELEASED leg's buffer runs from the session end
    to the next cycle boundary of ITS OWN anchor (unreleased legs pay no
    buffer — their cycle is still open). Returns the wall time consumed.

    When ``price_of_hour`` is a :class:`PriceTable` the vectorized biller
    runs (one numpy gather per interval instead of one Python call per
    hour per leg); arbitrary callables take the scalar-oracle path. Both
    produce bit-identical breakdowns — see ``docs/simulator-perf.md``.
    """
    if isinstance(price_of_hour, PriceTable) and len(set(session.legs)) == len(
        session.legs
    ):
        return _bill_session_table(session, price_of_hour, breakdown)
    return _bill_session_scalar(session, price_of_hour, breakdown)


def _bill_session_scalar(
    session: Session,
    price_of_hour,
    breakdown: Breakdown,
) -> float:
    """Scalar-oracle biller: the original per-hour-cell Python loop, kept
    verbatim as the reference :func:`_bill_session_table` must match
    bit-for-bit (pinned by hypothesis tests and ``sim_bench``)."""
    t = session.start_wall
    for comp, dur in session.intervals:
        remaining = dur
        while remaining > 1e-12:
            hour_idx = math.floor(t)
            step = min(remaining, (hour_idx + 1) - t)
            breakdown.time[comp] += step
            for leg in session.legs:
                leg_dollars = step * price_of_hour(leg, hour_idx)
                breakdown.cost[comp] += leg_dollars
                breakdown.add_leg_cost(leg, leg_dollars)
            t += step
            remaining -= step
    _bill_cycle_buffers(session, price_of_hour, breakdown, math.floor(t))
    breakdown.sessions += 1
    return session.used_hours


def _bill_session_table(
    session: Session,
    table: PriceTable,
    breakdown: Breakdown,
) -> float:
    """Vectorized biller: generate every interval's exact hour-cell layout
    in closed form (:func:`_interval_layout`, pure scalar arithmetic), then
    build the whole session's cell/price arrays in O(1) numpy ops and
    accumulate via sequential :func:`_fold` sums. Numpy call count scales
    with the number of components + legs, NOT with the interval count —
    checkpoint sessions carry hundreds of tiny intervals, and paying
    per-interval array overhead on those was slower than the scalar loop.

    Bit-exactness: each accumulator key receives exactly the addends the
    scalar loop feeds it, in the scalar loop's order — ``time[comp]`` /
    ``cost[comp]`` in interval order restricted to that component
    (cell-major, leg-minor for cost), ``leg_cost[leg]`` in global interval
    order — and :func:`_fold` is a strict left-to-right sum."""
    t = session.start_wall
    legs = session.legs
    rows = [table.row(leg) for leg in legs]
    row_len = rows[0].shape[0]

    # pass 1: pure-scalar cell layout per interval
    offsets, firsts, cell0s = [], [], []          # per non-empty interval
    tail_at, tail_val = [], []                    # tail-cell positions
    spans: Dict[str, list] = {}                   # comp -> [(start, stop)]
    total = 0
    for comp, dur in session.intervals:
        first_hour, cell0, n_ones, tail, t = _interval_layout(t, dur)
        if cell0 == 0.0:
            continue
        n_cells = 1 + n_ones + (1 if tail else 0)
        offsets.append(total)
        firsts.append(first_hour)
        cell0s.append(cell0)
        if tail:
            tail_at.append(total + n_cells - 1)
            tail_val.append(tail)
        spans.setdefault(comp, []).append((total, total + n_cells))
        total += n_cells

    if total:
        # pass 2: one array build + one price gather for the whole session
        steps_all = np.ones(total)
        steps_all[offsets] = cell0s
        if tail_at:
            steps_all[tail_at] = tail_val
        # hour of cell k = first_hour of its interval + (k - interval start),
        # clamped to the trace end like PriceTable.__call__
        hour_idx = np.repeat(
            np.asarray(firsts) - np.asarray(offsets), np.diff(offsets + [total])
        ) + np.arange(total)
        np.minimum(hour_idx, row_len - 1, out=hour_idx)
        # dollars[k, j] = steps[k] * price(leg j, hour k): the scalar
        # loop's per-cell products, computed in one broadcast
        dollars = steps_all[:, None] * np.stack(
            [row[hour_idx] for row in rows], axis=1
        )
        for comp, sp in spans.items():
            comp_rows = (
                dollars[sp[0][0]:sp[0][1]]
                if len(sp) == 1
                else np.concatenate([dollars[a:b] for a, b in sp])
            )
            breakdown.time[comp] = _fold(
                breakdown.time[comp],
                steps_all[sp[0][0]:sp[0][1]]
                if len(sp) == 1
                else np.concatenate([steps_all[a:b] for a, b in sp]),
            )
            breakdown.cost[comp] = _fold(breakdown.cost[comp], comp_rows.ravel())
        for j, leg in enumerate(legs):
            breakdown.leg_cost[leg] = _fold(
                breakdown.leg_cost.get(leg, 0.0), dollars[:, j]
            )
    _bill_cycle_buffers(session, table, breakdown, math.floor(t))
    breakdown.sessions += 1
    return session.used_hours


def _bill_cycle_buffers(
    session: Session,
    price_of_hour,
    breakdown: Breakdown,
    tail_hour: int,
) -> None:
    """Charge each released leg's unused billing-cycle remainder (shared by
    both billers; identical arithmetic to the original inline block)."""
    used = session.used_hours
    if session.leg_anchors is None:
        # legacy aligned cycles: every leg billed ceil(used) whole hours
        billed = math.ceil(max(used, 1e-9) / BILLING_CYCLE_HOURS) * BILLING_CYCLE_HOURS
        buffer_hours = billed - used
        for leg in session.legs:
            leg_buffer = buffer_hours * price_of_hour(leg, tail_hour)
            breakdown.cost["billing_buffer"] += leg_buffer
            breakdown.add_leg_cost(leg, leg_buffer)
    else:
        releases = session.leg_releases or (True,) * len(session.legs)
        end = session.start_wall + used
        for leg, anchor, released in zip(session.legs, session.leg_anchors, releases):
            if not released:
                continue  # cycle still open; settled by a later session
            # anchor == session start reproduces the legacy ceil(used)
            # arithmetic EXACTLY (no (start + used) - anchor float drift)
            held = used if anchor == session.start_wall else end - anchor
            buffer_hours = _held_buffer_hours(held)
            leg_buffer = buffer_hours * price_of_hour(leg, tail_hour)
            breakdown.cost["billing_buffer"] += leg_buffer
            breakdown.add_leg_cost(leg, leg_buffer)


def _held_buffer_hours(held: float) -> float:
    """Unused remainder of the billing cycle open after ``held`` hours of
    occupancy since the leg's anchor: the distance to the next cycle
    boundary, one full cycle if the tenure never ran (whole-hour billing
    starts at provisioning, exactly like the legacy ceil rule)."""
    held = max(held, 0.0)
    billed = math.ceil(max(held, 1e-9) / BILLING_CYCLE_HOURS) * BILLING_CYCLE_HOURS
    return billed - held


def settle_leg(
    breakdown: Breakdown,
    market_id: int,
    anchor: float,
    end_wall: float,
    price_of_hour,
) -> float:
    """Close a staggered leg's final billing cycle OUTSIDE a session: charge
    the unused remainder from ``end_wall`` (when the leg's occupancy really
    ended) to the next cycle boundary of its ``anchor``. Used when a leg
    deferred its buffer (``leg_releases`` False) but the allocation that
    replaced it no longer carries the leg. Returns the dollars charged."""
    buffer_hours = _held_buffer_hours(end_wall - anchor)
    dollars = buffer_hours * price_of_hour(market_id, math.floor(end_wall))
    breakdown.cost["billing_buffer"] += dollars
    breakdown.add_leg_cost(market_id, dollars)
    return dollars
