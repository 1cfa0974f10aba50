"""``repro_torch.obs`` — typed, zero-overhead-when-off event telemetry (port
of ``repro.obs``, with the same exports plus the JSONL helpers).

One traced timeline across the five loops that used to run blind — the
training orchestrator, both simulator engines, the serving fleet (static
and autoscaled), the decode engine, and the router — with the accounting
ledger as its correctness oracle: replaying a run's event log re-drives
the REAL billing functions (``bill_session`` / ``settle_leg`` /
``RouterStats.add``) and must reconstruct every ``Breakdown`` time/cost
component bit-exactly. Every billed hour is justified by events, the same
discipline the scalar billing oracles enforce on the vectorized core.

* :mod:`repro_torch.obs.events`   — the frozen event registry (~15 dataclasses
  sharing the monotone trace clock ``t``);
* :mod:`repro_torch.obs.recorder` — the append-only in-memory recorder plus the
  :class:`~repro_torch.obs.recorder.NullRecorder` DEFAULT: with telemetry off,
  instrumented code performs one attribute check per loop and constructs
  nothing, so every pinned bit-exact path stays byte-identical;
* :mod:`repro_torch.obs.export`   — JSONL event logs (exact float round-trip)
  and Chrome/Perfetto ``trace_event`` export, one track per
  market/replica/engine lane;
* :mod:`repro_torch.obs.replay`   — the load-bearing piece: event log →
  ``Breakdown``, bit-exact, with a CLI (``python -m repro_torch.obs.replay``)
  CI uses to validate bench traces against their recorded breakdowns;
* :mod:`repro_torch.obs.log`      — the small structured stderr logger the
  launchers use instead of ad-hoc ``print`` (stdout stays machine-owned:
  ``PLAN_JSON`` lines, CSV rows, trace files).

See ``docs/observability.md`` for the event schema and replay contract.
"""
from repro_torch.obs import events
from repro_torch.obs.export import read_jsonl, write_jsonl
from repro_torch.obs.log import get_logger
from repro_torch.obs.recorder import NullRecorder, Recorder, current, recording

__all__ = [
    "NullRecorder",
    "Recorder",
    "current",
    "events",
    "get_logger",
    "read_jsonl",
    "recording",
    "write_jsonl",
]
