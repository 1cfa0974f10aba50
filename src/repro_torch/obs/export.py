"""Event-log serialization: JSONL on disk, Chrome ``trace_event`` for eyes
(the port's copy of ``repro.obs.export``; only its imports differ).

JSONL is the canonical format — one ``events.as_dict`` object per line.
Python's ``json`` emits shortest-round-trip floats, so a write/read
cycle reconstructs every float bit-exactly; the replay oracle depends on
this (and ``tests/test_torch_serve_fleet.py`` pins it).

The Chrome export is lossy-by-design visualization for
``chrome://tracing`` / https://ui.perfetto.dev: one process per run, one
track (thread) per market / replica / engine lane, sessions and router
intervals as complete ("X") slices, revocations as instants, gauges and
scaler decisions as counter tracks. One trace-hour renders as one
second (1 h = 1e6 µs) so day-scale runs stay navigable.
"""
from __future__ import annotations

import json
from pathlib import Path
from typing import Iterable, List

from repro_torch.obs import events as ev

US_PER_HOUR = 1_000_000  # render 1 trace-hour as 1 second


def write_jsonl(path, event_seq: Iterable) -> int:
    """Write events as JSONL; returns the number of lines written."""
    n = 0
    with open(path, "w") as fh:
        for event in event_seq:
            fh.write(json.dumps(ev.as_dict(event), separators=(",", ":")))
            fh.write("\n")
            n += 1
    return n


def read_jsonl(path) -> List:
    """Read a JSONL event log back into typed event instances."""
    out: List = []
    with open(path) as fh:
        for line in fh:
            line = line.strip()
            if line:
                out.append(ev.from_dict(json.loads(line)))
    return out


def _us(t_hours: float) -> int:
    return int(round(t_hours * US_PER_HOUR))


def to_chrome_trace(event_seq: Iterable) -> dict:
    """Build a Chrome ``trace_event`` JSON object from an event stream."""
    trace: List[dict] = []
    pid = 0
    run_label = "trace"

    def meta(name: str, tid: int, sort: int) -> None:
        trace.append(
            {
                "name": "thread_name",
                "ph": "M",
                "pid": pid,
                "tid": tid,
                "args": {"name": name},
            }
        )
        trace.append(
            {
                "name": "thread_sort_index",
                "ph": "M",
                "pid": pid,
                "tid": tid,
                "args": {"sort_index": sort},
            }
        )

    def slice_(name: str, tid: int, t0: float, dur: float, args: dict) -> None:
        trace.append(
            {
                "name": name,
                "ph": "X",
                "pid": pid,
                "tid": tid,
                "ts": _us(t0),
                "dur": max(_us(t0 + dur) - _us(t0), 1),
                "args": args,
            }
        )

    def instant(name: str, tid: int, t: float, args: dict) -> None:
        trace.append(
            {
                "name": name,
                "ph": "i",
                "pid": pid,
                "tid": tid,
                "ts": _us(t),
                "s": "t",
                "args": args,
            }
        )

    def counter(name: str, t: float, values: dict) -> None:
        trace.append(
            {
                "name": name,
                "ph": "C",
                "pid": pid,
                "ts": _us(t),
                "args": values,
            }
        )

    # Track ids: markets get their market_id, replicas 1000+replica_id,
    # engine lanes 2000+lane, the router 3000.
    ROUTER_TID = 3000

    seen_tids = set()

    def market_tid(market_id: int) -> int:
        tid = int(market_id)
        if tid not in seen_tids:
            seen_tids.add(tid)
            meta(f"market {market_id}", tid, tid)
        return tid

    def replica_tid(replica_id: int) -> int:
        tid = 1000 + int(replica_id)
        if tid not in seen_tids:
            seen_tids.add(tid)
            meta(f"replica {replica_id}", tid, tid)
        return tid

    def lane_tid(lane: int) -> int:
        tid = 2000 + int(lane)
        if tid not in seen_tids:
            seen_tids.add(tid)
            meta(f"lane {lane}", tid, tid)
        return tid

    for event in event_seq:
        if isinstance(event, ev.RunStart):
            pid += 1
            seen_tids.clear()
            run_label = f"{event.subsystem}:{event.label}"
            trace.append(
                {
                    "name": "process_name",
                    "ph": "M",
                    "pid": pid,
                    "args": {"name": run_label},
                }
            )
            meta("router", ROUTER_TID, ROUTER_TID)
            seen_tids.add(ROUTER_TID)
        elif isinstance(event, ev.Provision):
            tid = (
                replica_tid(event.replica_id)
                if event.replica_id >= 0
                else market_tid(event.market_id)
            )
            instant(
                "provision",
                tid,
                event.t,
                {"market": event.market_id, "legs": list(event.legs)},
            )
        elif isinstance(event, ev.Revoke):
            tid = (
                replica_tid(event.replica_id)
                if event.replica_id >= 0
                else market_tid(event.market_id)
            )
            instant("revoke", tid, event.t, {"market": event.market_id})
        elif isinstance(event, ev.ReshardStart):
            instant(
                "reshard_start",
                ROUTER_TID,
                event.t,
                {"bytes": event.bytes_moved, "gbps": event.gbps},
            )
        elif isinstance(event, ev.ReshardDone):
            slice_(
                "reshard",
                ROUTER_TID,
                event.t - event.hours,
                event.hours,
                {"hours": event.hours},
            )
        elif isinstance(event, ev.SessionBilled):
            tid = market_tid(event.market_id)
            cursor = event.start_wall
            for component, hours in event.intervals:
                slice_(component, tid, cursor, hours, {"hours": hours})
                cursor += hours
        elif isinstance(event, ev.LegSettled):
            instant(
                "leg_settled",
                market_tid(event.market_id),
                event.t,
                {"anchor": event.anchor, "end_wall": event.end_wall},
            )
        elif isinstance(event, ev.RouterInterval):
            slice_(
                "interval",
                ROUTER_TID,
                event.t0,
                event.t1 - event.t0,
                {
                    "served": event.served_tokens,
                    "shed": event.shed_tokens,
                    "q_end": event.q_end,
                },
            )
            counter("backlog_tokens", event.t0, {"q": event.q_end})
        elif isinstance(event, ev.SloViolation):
            instant(
                "slo_violation", ROUTER_TID, event.t, {"seconds": event.seconds}
            )
        elif isinstance(event, ev.ScaleDecision):
            counter(
                "scaler_tokens_per_sec",
                event.t,
                {
                    "offered": event.offered_tokens_per_sec,
                    "forecast": event.forecast_tokens_per_sec,
                    "capacity": event.capacity_tokens_per_sec,
                },
            )
        elif isinstance(event, (ev.ScaleUp, ev.ScaleDown)):
            name = "scale_up" if isinstance(event, ev.ScaleUp) else "scale_down"
            delta = event.added if isinstance(event, ev.ScaleUp) else event.retired
            instant(name, ROUTER_TID, event.t, {"replicas": delta})
        elif isinstance(event, ev.Admit):
            instant(
                "admit",
                lane_tid(event.lane),
                event.t,
                {"request": event.request_id, "pages": event.pages_reserved},
            )
        elif isinstance(event, ev.Evict):
            instant(
                "evict",
                lane_tid(event.lane),
                event.t,
                {"request": event.request_id, "reason": event.reason},
            )
        elif isinstance(event, ev.Shed):
            instant(
                "shed",
                lane_tid(event.lane),
                event.t,
                {
                    "request": event.request_id,
                    "prompt": event.prompt_tokens,
                    "resume": event.resume_tokens,
                },
            )
        elif isinstance(event, ev.GaugeSample):
            counter(event.name, event.t, {"value": event.value})
        # RunEnd / BreakdownPin / PriceTrace / Drain carry no geometry.

    return {"traceEvents": trace, "displayTimeUnit": "ms"}


def main(argv=None) -> int:
    import argparse

    ap = argparse.ArgumentParser(
        description="Convert a JSONL event log to Chrome trace_event JSON."
    )
    ap.add_argument("trace", type=Path, help="input .jsonl event log")
    ap.add_argument(
        "-o",
        "--out",
        type=Path,
        default=None,
        help="output path (default: <trace>.chrome.json)",
    )
    args = ap.parse_args(argv)
    out = args.out or args.trace.with_suffix(".chrome.json")
    event_seq = read_jsonl(args.trace)
    with open(out, "w") as fh:
        json.dump(to_chrome_trace(event_seq), fh)
    print(f"CHROME_TRACE {out} events={len(event_seq)}")
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
