"""The replay oracle: event log → ``Breakdown``, bit-exactly (the port's
copy of ``repro.obs.replay``; only its imports differ).

A trace is a sequence of runs, each opened by a ``RunStart``. Replaying a
run re-drives the REAL accounting code — ``bill_session`` on every
``SessionBilled`` (against the run's ``PriceTrace`` table, or the
session's constant price), ``settle_leg`` on every ``LegSettled``, and
the router's own ``RouterStats.add`` fold over ``RouterInterval`` events
followed by one ``merge_into`` — in emission order. Because every
``Breakdown`` mutation in the instrumented loops goes through exactly
those three functions, the replayed breakdown matches the run's own,
float for float: every billed hour is justified by events.

Replay always prices through a :class:`PriceTable`, whatever engine
emitted the log — table and scalar billing are pinned bit-identical
repo-wide, and this is what makes the reference and vectorized simulator
engines emit *identical* logs (no engine-specific event fields exist).

Each instrumented run records its own breakdown as a ``BreakdownPin``
just before returning; :func:`verify_events` compares replay against pin
with ``==`` per component. The CLI (``python -m repro_torch.obs.replay
trace.jsonl``) exits nonzero on any mismatch — CI runs it on the bench
traces every build.
"""
from __future__ import annotations

import dataclasses
import sys
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np

from repro_torch.core.accounting import Breakdown, PriceTable, Session, bill_session, settle_leg
from repro_torch.obs import events as ev
from repro_torch.serve.router import RouterStats


@dataclasses.dataclass
class ReplayedRun:
    subsystem: str
    label: str
    breakdown: Breakdown
    pin: Optional[ev.BreakdownPin]
    n_events: int


def split_runs(event_seq: Sequence) -> List[List]:
    """Split a trace into runs on ``RunStart`` boundaries.

    Events before the first ``RunStart`` (engine-lane telemetry from a
    bare decode run, say) form no run and are dropped.
    """
    runs: List[List] = []
    for event in event_seq:
        if isinstance(event, ev.RunStart):
            runs.append([event])
        elif runs:
            runs[-1].append(event)
    return runs


def replay_run(run_events: Sequence) -> ReplayedRun:
    """Re-drive the billing code over one run's events."""
    start = run_events[0]
    assert isinstance(start, ev.RunStart), "a run must open with RunStart"
    table: Optional[PriceTable] = None
    bd = Breakdown()
    router = RouterStats()
    routed = False
    revocations = 0
    wall_hours = 0.0
    pin: Optional[ev.BreakdownPin] = None

    for event in run_events:
        if isinstance(event, ev.PriceTrace):
            table = PriceTable(np.array(event.prices, dtype=float))
        elif isinstance(event, ev.SessionBilled):
            if event.price_const is not None:
                price = PriceTable.constant(event.price_const)
            else:
                assert table is not None, "SessionBilled before PriceTrace"
                price = table
            session = Session(
                market_id=event.market_id,
                start_wall=event.start_wall,
                intervals=[(c, h) for c, h in event.intervals],
                legs=tuple(event.legs),
                leg_anchors=event.leg_anchors,
                leg_releases=event.leg_releases,
            )
            bill_session(session, price, bd)
        elif isinstance(event, ev.LegSettled):
            assert table is not None, "LegSettled before PriceTrace"
            settle_leg(bd, event.market_id, event.anchor, event.end_wall, table)
        elif isinstance(event, ev.RouterInterval):
            routed = True
            router.add(
                RouterStats(
                    offered_tokens=event.offered_tokens,
                    served_tokens=event.served_tokens,
                    shed_tokens=event.shed_tokens,
                    queued_token_seconds=event.queued_token_seconds,
                    slo_violation_seconds=event.slo_violation_seconds,
                    q_end=event.q_end,
                    delay_segments=[tuple(s) for s in event.delay_segments],
                )
            )
        elif isinstance(event, ev.Revoke):
            revocations += 1
        elif isinstance(event, ev.RunEnd):
            wall_hours = event.wall_hours
        elif isinstance(event, ev.BreakdownPin):
            pin = event

    if routed:
        router.merge_into(bd)
    bd.revocations = revocations
    bd.wall_time = wall_hours
    return ReplayedRun(
        subsystem=start.subsystem,
        label=start.label,
        breakdown=bd,
        pin=pin,
        n_events=len(run_events),
    )


def mismatches(bd: Breakdown, pin: ev.BreakdownPin) -> List[str]:
    """Every field where replay and pin disagree — compared with ``==``,
    not approx: the oracle's whole point is bit-exactness."""
    bad: List[str] = []
    for name, expected in pin.time:
        if bd.time[name] != expected:
            bad.append(f"time[{name}]: replay {bd.time[name]!r} != run {expected!r}")
    for name, expected in pin.cost:
        if bd.cost[name] != expected:
            bad.append(f"cost[{name}]: replay {bd.cost[name]!r} != run {expected!r}")
    pin_legs: Dict[int, float] = {m: c for m, c in pin.leg_cost}
    for market in sorted(set(bd.leg_cost) | set(pin_legs)):
        got, expected = bd.leg_cost.get(market), pin_legs.get(market)
        if got != expected:
            bad.append(f"leg_cost[{market}]: replay {got!r} != run {expected!r}")
    scalars: Tuple[Tuple[str, object, object], ...] = (
        ("revocations", bd.revocations, pin.revocations),
        ("sessions", bd.sessions, pin.sessions),
        ("wall_time", bd.wall_time, pin.wall_time),
        ("served_tokens", bd.served_tokens, pin.served_tokens),
        ("shed_tokens", bd.shed_tokens, pin.shed_tokens),
        (
            "queued_token_seconds",
            bd.queued_token_seconds,
            pin.queued_token_seconds,
        ),
    )
    for name, got, expected in scalars:
        if got != expected:
            bad.append(f"{name}: replay {got!r} != run {expected!r}")
    return bad


def verify_events(event_seq: Sequence) -> Tuple[List[ReplayedRun], List[str]]:
    """Replay every run and collect mismatch descriptions (empty == pass).

    A run without a ``BreakdownPin`` cannot be validated and is reported
    as a problem — instrumented loops always pin before returning.
    """
    problems: List[str] = []
    runs = [replay_run(run) for run in split_runs(event_seq)]
    for i, run in enumerate(runs):
        tag = f"run {i} ({run.subsystem}:{run.label})"
        if run.pin is None:
            problems.append(f"{tag}: no BreakdownPin recorded")
            continue
        problems.extend(f"{tag}: {m}" for m in mismatches(run.breakdown, run.pin))
    return runs, problems


def main(argv=None) -> int:
    import argparse

    from repro_torch.obs.export import read_jsonl

    ap = argparse.ArgumentParser(
        description=(
            "Replay JSONL event logs through the real billing code and "
            "verify each run's Breakdown bit-exactly against its pin."
        )
    )
    ap.add_argument("traces", nargs="+", help="JSONL event logs")
    args = ap.parse_args(argv)

    failed = False
    for path in args.traces:
        event_seq = read_jsonl(path)
        runs, problems = verify_events(event_seq)
        if not runs:
            print(f"REPLAY {path}: no runs (only {len(event_seq)} loose events)")
            continue
        for problem in problems:
            print(f"REPLAY {path}: MISMATCH {problem}", file=sys.stderr)
            failed = True
        ok = sum(1 for r in runs if r.pin is not None)
        print(
            f"REPLAY {path}: {len(runs)} run(s), {len(event_seq)} event(s), "
            f"{len(problems)} mismatch(es), {ok} pinned"
        )
    return 1 if failed else 0


if __name__ == "__main__":
    raise SystemExit(main())
