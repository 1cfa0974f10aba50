"""Demand-driven autoscaling for the serving fleet (the port's copy of
``repro.serve.autoscale``; only its imports and test references differ).

The static fleet sizes once to the trace PEAK and burns the night-time
headroom — BENCH_serve's diurnal and steady scenarios cost exactly the
same, which contradicts the paper's thesis that market structure (not
over-provisioning) buys availability cheaply. The scaler closes that gap
by walking the demand trace and resizing the fleet every interval (Qu et
al.'s heterogeneous-spot auto-scaler gives the rule shape):

* **scale-up** — whenever the *forecast* offered load (the max over a
  short look-ahead window, so capacity is live before the ramp arrives)
  breaks the fleet's sizing bars: aggregate capacity below
  ``target × capacity_headroom``, or the N−1 bar (capacity minus the
  largest replica below the raw target). Scale-ups are never gated by
  the cooldown — the SLO outranks thrash avoidance. The demand target is
  floored at the *currently offered* rate, so a bad forecast can never
  size the fleet below live traffic (the in-flight floor).
* **scale-down** — when fleet utilization (required capacity over held
  capacity) falls below ``low_water`` AND the cooldown since the last
  scale event has elapsed. The retiring replica's in-flight streams are
  shed and resumed on a survivor (:func:`drain_replica` — the engine's
  shed→resume round trip is token-identical, so a scale-down is
  invisible in the streams, exactly like a revocation).
* **cooldown** — scale-downs within ``cooldown_hours`` of ANY scale
  event (up, down, or the initial provisioning) are suppressed; this is
  the thrash guard: a demand dip right after a ramp never flaps the
  fleet.

The scaler is deliberately pure arithmetic over rates — it owns no
markets and no sessions. :class:`repro_torch.serve.fleet.FleetSimulator` with
``sizing="auto"`` consumes its decisions and does the provisioning,
billing, and routing; the engine-level drain is driven by
``launch/serve.py`` and pinned by tests/test_torch_serve_plan.py.
"""
from __future__ import annotations

import dataclasses
from typing import TYPE_CHECKING, List, Sequence, Tuple

from repro_torch.obs import events as obs_ev
from repro_torch.obs.recorder import current as obs_current

if TYPE_CHECKING:  # pragma: no cover
    from repro_torch.serve.engine import DecodeEngine

SCALE_KINDS = ("hold", "up", "down")


@dataclasses.dataclass(frozen=True)
class AutoscalePolicy:
    """Knobs for the demand-driven scaler."""

    #: hours of demand trace the scale-up rule looks ahead over (max of
    #: the window) — capacity must be live BEFORE the ramp arrives, since
    #: a replica takes startup + migration time to come up
    forecast_window_hours: int = 3
    #: scale-down low-water mark: retire capacity only when
    #: required/held utilization drops below this fraction
    low_water: float = 0.5
    #: minimum hours between a scale event and a subsequent scale-DOWN
    cooldown_hours: float = 3.0
    #: never scale below this many replicas (N−1 needs a survivor to
    #: absorb load, and the params have to live somewhere)
    min_replicas: int = 1

    def __post_init__(self):
        assert self.forecast_window_hours >= 1
        assert 0.0 < self.low_water < 1.0
        assert self.cooldown_hours >= 0.0
        assert self.min_replicas >= 1


@dataclasses.dataclass(frozen=True)
class ScaleDecision:
    """One interval's verdict: ``kind`` ∈ ``SCALE_KINDS`` and the demand
    target (tokens/sec, already floored at the offered rate) the fleet
    must satisfy this interval."""

    kind: str
    target_tokens_per_sec: float


class AutoScaler:
    """The rule engine: forecast → sizing bars → up/down/hold.

    Stateful only in its event log (``events``) and the cooldown clock;
    every decision is a pure function of (now, replica rates, forecast,
    offered) so random-trace property tests can drive it directly.
    """

    def __init__(
        self,
        policy: AutoscalePolicy = AutoscalePolicy(),
        *,
        capacity_headroom: float,
        survive_one_loss: bool = True,
    ):
        self.policy = policy
        self.capacity_headroom = float(capacity_headroom)
        self.survive_one_loss = survive_one_loss
        #: (at_hours, kind) for every non-hold event, in time order
        self.events: List[Tuple[float, str]] = []
        self._last_event: float | None = None

    # -- the rules -------------------------------------------------------

    def forecast(self, rate: Sequence[float], hour: int) -> float:
        """Max offered rate over ``[hour, hour + window)`` of the trace
        (clamped to the trace; past the end the last hour persists)."""
        if not len(rate):
            return 0.0
        lo = min(max(int(hour), 0), len(rate) - 1)
        hi = min(lo + self.policy.forecast_window_hours, len(rate))
        return max(float(rate[h]) for h in range(lo, hi))

    def satisfied(self, rates: Sequence[float], target: float) -> bool:
        """The fleet sizing bars, identical to ``provision_fleet``:
        capacity ≥ target × headroom AND (N−1) capacity − max ≥ target."""
        cap = sum(rates)
        if cap < target * self.capacity_headroom:
            return False
        if self.survive_one_loss and rates and cap - max(rates) < target:
            return False
        return True

    def cooldown_ok(self, now: float) -> bool:
        if self._last_event is None:
            return True
        return now - self._last_event >= self.policy.cooldown_hours

    def decide(
        self,
        now: float,
        replica_rates: Sequence[float],
        *,
        forecast: float,
        offered_now: float,
    ) -> ScaleDecision:
        """One interval's verdict. The target is the forecast floored at
        the live offered rate — the scaler may be wrong about the future
        but never sizes below the present."""
        target = max(float(forecast), float(offered_now), 0.0)
        if not self.satisfied(replica_rates, target):
            return ScaleDecision("up", target)
        cap = sum(replica_rates)
        required = target * self.capacity_headroom
        if (
            cap > 0.0
            and required / cap < self.policy.low_water
            and len(replica_rates) > self.policy.min_replicas
            and self.cooldown_ok(now)
        ):
            return ScaleDecision("down", target)
        return ScaleDecision("hold", target)

    def record(self, now: float, kind: str) -> None:
        """Log a realized scale event (the simulator calls this only when
        a decision actually changed the fleet) and reset the cooldown
        clock. ``kind="init"`` marks the initial provisioning: it is not
        a scale event but it arms the cooldown, so the fleet cannot
        scale down in the first ``cooldown_hours``."""
        assert kind in SCALE_KINDS + ("init",), kind
        if kind == "hold":
            return
        self.events.append((float(now), kind))
        self._last_event = float(now)

    @property
    def scale_ups(self) -> int:
        return sum(1 for _, k in self.events if k == "up")

    @property
    def scale_downs(self) -> int:
        return sum(1 for _, k in self.events if k == "down")


def drain_replica(src: "DecodeEngine", dst: "DecodeEngine") -> int:
    """Scale-down an engine replica: shed every in-flight stream from the
    retiring engine and resubmit it on a survivor. The engine's
    shed→resume round trip re-prefills ``prompt + generated[:-1]``, so
    the drained streams complete token-identically to uninterrupted
    serving (pinned in tests/test_torch_serve_plan.py) — a scale-down is as
    invisible as a revocation. Returns the number of streams moved."""
    resumed = src.shed()
    for req in resumed:
        dst.submit(req)
    rec = obs_current()
    if rec.enabled:
        rec.emit(obs_ev.Drain(t=float(src.steps), moved_requests=len(resumed)))
    return len(resumed)
