"""SLO-aware spot provisioning for a fleet of inference replicas (the
port's copy of ``repro.serve.fleet``: the same float expressions, so the
same reports bit for bit; only its imports differ).

The paper admits a BATCH job to a spot market when the market's MTTR
dominates the job's wall time; a serving fleet has no wall time — it runs
until turned off. The serving analogue (Qu et al., *A Reliable and
Cost-Efficient Auto-Scaling System for Web Applications Using
Heterogeneous Spot Instances*) is availability from market diversity:

* **footprint** — a replica holds params + KV cache at the configured
  batch/context (``dist.meshplan.serve_state_bytes``), never optimizer
  state, so suitability runs the same ``find_suitable_allocations`` path
  as training with a strictly smaller memory requirement;
* **admission** — a market is admitted when its MTTR dominates a *rolling
  SLO horizon* (``lifetime_factor × slo_horizon_hours``), the window over
  which the operator promises the SLO, instead of a job length. The
  horizon is WALL clock: a faster shape does not shrink its exposure the
  way it shrinks a batch job's, so admission deliberately does not divide
  by throughput;
* **diversity** — replicas spread across low-correlation markets
  (``find_low_correlation``): one zone-wide price spike may take one
  replica, never the fleet. Capacity is sized so the aggregate tokens/sec
  meets the target with ``capacity_headroom``;
* **revocation** — a revoked replica is a params-only migration onto a
  replacement shape (``repro_torch.serve.migrate``); the dead replica's load
  re-routes to the survivors through the open-loop router until the
  replacement is live. No checkpoints, no standby over-replication.

Per-replica billing runs through ``core.accounting``, one session per
replica tenure: each replica's whole-hour billing cycles start at its own
provisioning instant (naturally staggered clocks — a repair bills only
its own partial hours), and ``Breakdown.leg_cost`` decomposes the fleet
bill exactly. The explicit ``leg_anchors``/``leg_releases`` machinery is
the multi-leg-session form of the same rule, used by the training
orchestrator's split-repair path.
"""
from __future__ import annotations

import dataclasses
import math
from typing import Callable, List, Optional, Sequence, Set, Tuple

import numpy as np

from repro_torch.core import provisioner as alg
from repro_torch.core.accounting import Breakdown, PriceTable, Session, bill_session
from repro_torch.obs import events as obs_ev
from repro_torch.obs.recorder import current as obs_current
from repro_torch.core.allocation import Allocation
from repro_torch.core.market import MarketSet, next_revocation_table, shape_throughput
from repro_torch.core.policies import Job, OverheadModel, SiwoftPolicy
from repro_torch.core.units import SECONDS_PER_HOUR
from repro_torch.serve.autoscale import AutoscalePolicy, AutoScaler
from repro_torch.serve.migrate import CACHE_POLICIES, MigrationCost, migration_cost
from repro_torch.serve.router import (
    CapacityEvent,
    RouterStats,
    idle_headroom_tokens,
    route_trace,
)

#: measured-throughput correction hook: allocation → multiplicative factor
RateCorrection = Callable[[Allocation], float]


@dataclasses.dataclass(frozen=True)
class ServePolicy:
    """Fleet provisioning + SLO knobs (the serving face of SiwoftPolicy)."""

    name: str = "serve_fleet"
    lifetime_factor: float = 2.0          # MTTR ≥ factor × SLO horizon
    slo_horizon_hours: float = 24.0       # rolling horizon the SLO covers
    correlation_threshold: float = 0.2    # pairwise spread across replicas
    cache_policy: str = "drop"            # "drop" | "migrate" (migrate.py)
    capacity_headroom: float = 1.1        # provision target × headroom
    # N-1 sizing: keep adding replicas until the fleet still meets the raw
    # target with its LARGEST replica gone — one revocation (the failure
    # unit the MTTR admission prices) must not break the SLO while the
    # params-only repair migrates in. This is capacity planning, not
    # standby over-replication: every replica serves traffic.
    survive_one_loss: bool = True
    max_replicas: int = 32
    max_legs: int = 2                     # split replicas when none fits
    # SLO definition the router enforces
    max_delay_seconds: float = 30.0       # queueing delay above = violation
    shed_delay_seconds: float = 120.0     # clients abandon past this

    def __post_init__(self):
        assert self.cache_policy in CACHE_POLICIES, self.cache_policy

    def as_siwoft(self) -> SiwoftPolicy:
        """The SiwoftPolicy the shared Alg.-1 primitives consume."""
        return SiwoftPolicy(
            lifetime_factor=self.lifetime_factor,
            correlation_threshold=self.correlation_threshold,
            max_legs=self.max_legs,
        )


@dataclasses.dataclass(frozen=True)
class ServingWorkload:
    """What the fleet must deliver and what one replica costs to hold.

    ``replica_tokens_per_sec`` is the decode rate of a replica on the
    1-device reference shape; a replica on an allocation with relative
    throughput θ delivers ``θ ×`` that (``shape_throughput`` — corrected
    online by a ``ThroughputTracker`` when one is wired in).
    """

    target_tokens_per_sec: float
    replica_tokens_per_sec: float
    state_gb: float                 # serving footprint: params + KV cache
    param_bytes: int                # migration pricing (params move)
    cache_bytes: int = 0            # migration pricing (cache per policy)
    prefill_tokens_per_sec: float = 0.0   # 0 -> 8× the decode rate
    inflight_context_tokens: float = 0.0  # re-prefilled on a cache drop

    @property
    def prefill_rate(self) -> float:
        return self.prefill_tokens_per_sec or 8.0 * self.replica_tokens_per_sec


@dataclasses.dataclass(frozen=True)
class Replica:
    replica_id: int
    allocation: Allocation
    tokens_per_sec: float


@dataclasses.dataclass
class FleetPlan:
    replicas: List[Replica]
    relaxed_correlation: bool = False  # diversity filter had to be relaxed

    @property
    def capacity_tokens_per_sec(self) -> float:
        return sum(r.tokens_per_sec for r in self.replicas)

    @property
    def markets(self) -> Tuple[int, ...]:
        return tuple(m for r in self.replicas for m in r.allocation.markets)


def replica_rate(
    workload: ServingWorkload,
    feats: alg.MarketFeatures,
    alloc: Allocation,
    correction: float = 1.0,
) -> float:
    """Tokens/sec a replica on ``alloc`` delivers: the reference decode
    rate scaled by the allocation's relative throughput (analytic or
    measured, see ``MarketFeatures.throughput``), times a measured
    correction (``ThroughputTracker.correction``) when available."""
    return (
        workload.replica_tokens_per_sec
        * alg.allocation_throughput(alloc, feats)
        * max(float(correction), 1e-9)
    )


def _admitted(
    workload: ServingWorkload,
    feats: alg.MarketFeatures,
    policy: ServePolicy,
    exclude: Set[int],
    rate_correction: Optional[RateCorrection] = None,
) -> List[Allocation]:
    """Suitable allocations whose MTTR dominates the rolling SLO horizon,
    cheapest-per-delivered-token first.

    Suitability reuses the training split search (a serving replica whose
    params fit no single shape splits over DCN like a training job); the
    admission test deliberately replaces the job-wall-time comparison with
    the wall-clock horizon — serving exposure does not shrink on faster
    shapes."""
    job = Job(length_hours=policy.slo_horizon_hours, memory_gb=workload.state_gb)
    cands = alg.find_suitable_allocations(
        job, feats, policy.as_siwoft(), exclude=exclude
    )
    floor = policy.lifetime_factor * policy.slo_horizon_hours
    admitted = [a for a in cands if alg.allocation_mttr(a, feats) >= floor]
    pool = admitted if admitted else cands  # Alg.-1 fallback discipline
    corr = rate_correction if rate_correction is not None else (lambda a: 1.0)
    return sorted(
        pool,
        key=lambda a: (
            alg.allocation_price(a, feats)
            / max(replica_rate(workload, feats, a, corr(a)), 1e-9),
            a.markets,
        ),
    )


def _diverse(
    alloc: Allocation,
    placed: Sequence[int],
    feats: alg.MarketFeatures,
    policy: ServePolicy,
) -> bool:
    """Every leg of ``alloc`` co-revokes below the threshold with every
    market the fleet already holds — find_low_correlation semantics, so
    one spike cannot take two replicas."""
    if not placed:
        return True
    W = alg.find_low_correlation(
        feats, placed[0], policy, surviving=tuple(placed[1:])
    )
    return all(m in W for m in alloc.markets)


def provision_fleet(
    workload: ServingWorkload,
    feats: alg.MarketFeatures,
    policy: ServePolicy,
    *,
    exclude: Set[int] = frozenset(),
    existing: Sequence[Replica] = (),
    rate_correction: Optional[RateCorrection] = None,
) -> FleetPlan:
    """Size and place the fleet: admitted allocations, cheapest per
    delivered token first, each low-correlated with everything already
    placed, until the aggregate capacity covers target × headroom.

    With ``survive_one_loss`` (default) sizing continues past the target
    until the fleet minus its largest replica still covers the RAW target
    — the N-1 bar a single revocation must not break while its repair
    migrates in. If the diversity filter starves the pool before the
    target is met, it is relaxed (same refill discipline as Alg. 1 step
    13) and the plan is flagged ``relaxed_correlation`` — capacity beats
    purity, but the operator can see the compromise.

    ``existing`` is the autoscaler's incremental form: replicas the fleet
    already holds count toward both sizing bars, the diversity filter,
    and ``max_replicas``, and the returned plan contains only the NEW
    replicas (empty when the existing fleet already satisfies the bars).
    ``rate_correction`` (allocation → factor) applies a measured
    ``ThroughputTracker`` correction to every candidate's rate, so
    ranking and sizing consume real decode speed instead of the analytic
    ``n^α`` when a tracker is wired in."""
    target = workload.target_tokens_per_sec * policy.capacity_headroom
    corr = rate_correction if rate_correction is not None else (lambda a: 1.0)

    def satisfied(reps: Sequence[Replica]) -> bool:
        rates = [r.tokens_per_sec for r in existing] + [
            r.tokens_per_sec for r in reps
        ]
        cap = sum(rates)
        if cap < target:
            return False
        if policy.survive_one_loss and rates:
            worst = max(rates)
            if cap - worst < workload.target_tokens_per_sec:
                return False
        return True

    replicas: List[Replica] = []
    used: Set[int] = set(exclude) | {
        m for r in existing for m in r.allocation.markets
    }
    relaxed = False
    for strict in (True, False):
        cands = _admitted(workload, feats, policy, used, rate_correction)
        for a in cands:
            if len(existing) + len(replicas) >= policy.max_replicas:
                break
            if satisfied(replicas):
                break
            if any(m in used for m in a.markets):
                continue
            placed = [
                m for r in existing for m in r.allocation.markets
            ] + [m for r in replicas for m in r.allocation.markets]
            if strict and not _diverse(a, placed, feats, policy):
                continue
            if not strict:
                relaxed = True
            replicas.append(
                Replica(
                    len(replicas), a, replica_rate(workload, feats, a, corr(a))
                )
            )
            used.update(a.markets)
        if satisfied(replicas):
            break
    if not replicas and not existing:
        raise ValueError(
            f"no admitted allocation fits a {workload.state_gb} GB replica"
        )
    return FleetPlan(replicas=replicas, relaxed_correlation=relaxed)


def repair_fleet(
    workload: ServingWorkload,
    feats: alg.MarketFeatures,
    policy: ServePolicy,
    *,
    revoked_market: int,
    survivors: Sequence[int],
    exclude: Set[int],
    lost: Replica,
    rate_correction: Optional[RateCorrection] = None,
) -> Optional[Replica]:
    """Replacement for one revoked replica: low-correlated with the
    revoked market AND every surviving replica (step-13 semantics),
    admitted against the rolling horizon, preferring the lost replica's
    device shape (a same-shape replacement reuses the compiled serving
    step — the params-only reshard is the whole migration)."""
    used = set(exclude) | set(survivors) | {revoked_market}
    cands = _admitted(workload, feats, policy, used, rate_correction)
    W = alg.find_low_correlation(
        feats, revoked_market, policy, surviving=tuple(survivors)
    )
    diverse = [a for a in cands if all(m in W for m in a.markets)]
    pool = diverse if diverse else cands
    if not pool:
        return None
    corr = rate_correction if rate_correction is not None else (lambda a: 1.0)
    lost_shape = lost.allocation.device_counts
    best = min(
        pool,
        key=lambda a: (
            0 if a.device_counts == lost_shape else 1,
            alg.allocation_price(a, feats)
            / max(replica_rate(workload, feats, a, corr(a)), 1e-9),
            a.markets,
        ),
    )
    return Replica(
        lost.replica_id, best, replica_rate(workload, feats, best, corr(best))
    )


# ---------------------------------------------------------------------------
# Fleet simulation on replayable price traces
# ---------------------------------------------------------------------------

@dataclasses.dataclass
class FleetReport:
    breakdown: Breakdown
    router: RouterStats
    revocations: int
    repairs: int
    migrated_bytes: int            # params(+cache) over DCN, fleet policy
    restored_bytes: int            # full serving state through storage
    replicas_provisioned: int
    markets_used: List[int]
    capacity_tokens_per_sec: float
    relaxed_correlation: bool = False
    # demand-driven sizing counters (0 for every static-sized policy)
    scale_ups: int = 0
    scale_downs: int = 0
    #: tokens of capacity the offered trace never used — what a
    #: peak-sized fleet burns at night and the autoscaler exists to shed
    idle_headroom_tokens: float = 0.0

    @property
    def cost_dollars(self) -> float:
        return self.breakdown.total_cost

    @property
    def slo_violation_seconds(self) -> float:
        return self.breakdown.time["slo_violation"] * SECONDS_PER_HOUR

    @property
    def p50_delay_seconds(self) -> float:
        return self.router.p50_delay_seconds

    @property
    def p99_delay_seconds(self) -> float:
        return self.router.p99_delay_seconds


class FleetSimulator:
    """Drive a fleet through a future price trace, deterministically.

    ``mode="fleet"`` — the tentpole policy: SLO-horizon admission,
    correlation spread, params-only migration repair.
    ``mode="static"`` — the over-replication baseline: capacity ×
    ``policy.capacity_headroom`` on the cheapest suitable spot markets
    with NO market intelligence (no MTTR admission, no correlation
    spread); a revoked replica is replaced after a FULL serving-state
    restore through remote storage (what running today's serve.py behind
    an autoscaler amounts to).

    ``throughput_mode`` selects where the reference replica rate comes
    from: ``"analytic"`` (default) uses the workload's closed-form
    ``replica_tokens_per_sec``; ``"engine"`` replaces it with
    ``measured_tokens_per_sec`` — the tokens/sec a real
    :class:`repro_torch.serve.engine.DecodeEngine` measured on the reference
    shape — so provisioning, N-1 sizing, and the router all consume the
    engine's observed rate. With a measured rate equal to the analytic
    reference the two modes produce identical reports (pinned in
    tests/test_torch_serve_fleet.py), so the analytic baseline stays bit-exact.

    ``sizing`` selects WHEN capacity is sized: ``"static"`` (default, the
    byte-exact pinned baseline) sizes once to the workload's fixed target
    and only repairs revocations; ``"auto"`` walks the demand trace with
    an :class:`repro_torch.serve.autoscale.AutoScaler` — scale-up ahead of
    forecast ramps, scale-down (cheapest-kept-first retirement) under the
    low-water mark after a cooldown, and demand-driven repair: a revoked
    replica is replaced only if the remaining fleet no longer clears the
    CURRENT interval's bars, not unconditionally. ``sizing="auto"``
    requires ``mode="fleet"``.
    """

    def __init__(
        self,
        history: MarketSet,
        future: MarketSet,
        workload: ServingWorkload,
        policy: ServePolicy,
        overheads: OverheadModel = OverheadModel(),
        *,
        mode: str = "fleet",
        sizing: str = "static",
        autoscale: Optional[AutoscalePolicy] = None,
        tracker=None,  # Optional[dist.meshplan.ThroughputTracker]
        throughput_mode: str = "analytic",
        measured_tokens_per_sec: Optional[float] = None,
    ):
        assert mode in ("fleet", "static")
        assert sizing in ("static", "auto")
        assert throughput_mode in ("analytic", "engine")
        if sizing == "auto" and mode != "fleet":
            raise ValueError("sizing='auto' requires mode='fleet'")
        if throughput_mode == "engine":
            if not measured_tokens_per_sec or measured_tokens_per_sec <= 0:
                raise ValueError(
                    "throughput_mode='engine' needs a positive "
                    "measured_tokens_per_sec from a DecodeEngine"
                )
            workload = dataclasses.replace(
                workload,
                replica_tokens_per_sec=float(measured_tokens_per_sec),
            )
        self.throughput_mode = throughput_mode
        self.feats = alg.MarketFeatures.from_history(history)
        self.future = future
        self.workload = workload
        self.policy = policy
        self.ov = overheads
        self.mode = mode
        self.sizing = sizing
        self.autoscale = autoscale if autoscale is not None else AutoscalePolicy()
        self.tracker = tracker
        self._rev = future.revocation_matrix()
        # vectorized trace indexes (one O(markets × hours) pass each):
        # next-revocation suffix table for O(1) "when does this leg die?"
        # queries, and an hour -> revoking-market-set map so the hourly
        # loops touch Python only on event hours
        self._next_rev = next_revocation_table(self._rev)
        self._rev_hours: dict = {}
        for m, h in zip(*np.nonzero(self._rev)):
            self._rev_hours.setdefault(int(h), set()).add(int(m))
        # with a tracker wired in, provisioning itself consumes measured
        # rates (ranking, sizing bars, Replica.tokens_per_sec); without
        # one the analytic model stands and the hook stays None so the
        # pinned baselines keep their exact float expressions
        self._corr: Optional[RateCorrection] = (
            self._rate_correction if tracker is not None else None
        )

    # -- static-baseline provisioning (no market intelligence) ----------
    def _provision_static(self, exclude: Set[int]) -> FleetPlan:
        job = Job(
            length_hours=self.policy.slo_horizon_hours,
            memory_gb=self.workload.state_gb,
        )
        cands = [
            Allocation.single(i, int(self.feats.device_count[i]))
            for i in alg.find_suitable_servers(job, self.feats)
            if i not in exclude
        ]
        cands.sort(key=lambda a: (float(self.feats.avg_price[a.legs[0].market]),
                                  a.markets))
        target = (
            self.workload.target_tokens_per_sec * self.policy.capacity_headroom
        )
        corr = self._corr if self._corr is not None else (lambda a: 1.0)
        replicas: List[Replica] = []
        used = set(exclude)
        for a in cands:
            if sum(r.tokens_per_sec for r in replicas) >= target:
                break
            if len(replicas) >= self.policy.max_replicas:
                break
            if any(m in used for m in a.markets):
                continue
            replicas.append(
                Replica(
                    len(replicas),
                    a,
                    replica_rate(self.workload, self.feats, a, corr(a)),
                )
            )
            used.update(a.markets)
        if not replicas:
            raise ValueError("static baseline: no suitable market")
        return FleetPlan(replicas=replicas)

    def _rate_correction(self, alloc: Allocation) -> float:
        """Measured-vs-analytic correction for the allocation's mesh-plan
        key, when a ThroughputTracker from a real serving loop is wired
        in; 1.0 (analytic model stands) otherwise.

        Same anchoring convention as the training orchestrator: the
        analytic table covers EVERY observed plan key at the reference
        bandwidth (the tracker's ratio corrects deviation from the
        scaling LAW; the bandwidth-aware base value lives in the replica
        rate itself), and the corrected rate is capped at the model's
        sublinear ceiling so no calibration can claim superlinear
        scaling."""
        if self.tracker is None:
            return 1.0
        from repro_torch.core.market import THROUGHPUT_EFFICIENCY_CEIL
        from repro_torch.dist.meshplan import mesh_shape_for

        n = alloc.total_devices
        key = (n, mesh_shape_for(n))
        analytic = {k: shape_throughput(k[0]) for k in self.tracker.measured}
        analytic[key] = shape_throughput(n)
        corr = self.tracker.correction(key, analytic)
        base = alg.allocation_throughput(alloc, self.feats)
        cap = float(n) ** THROUGHPUT_EFFICIENCY_CEIL
        return min(corr, cap / max(base, 1e-9))

    def _next_revocation_hour(self, alloc: Allocation, wall: float) -> Optional[int]:
        h0 = int(math.ceil(wall))
        if h0 < 0:
            h0 = 0
        if h0 >= self._next_rev.shape[1]:
            return None
        best = None
        for m in alloc.markets:
            h = int(self._next_rev[m, h0])
            if h >= 0:
                best = h if best is None else min(best, h)
        return best

    def run(
        self,
        hours: float,
        rate_tokens_per_sec: Sequence[float],
    ) -> FleetReport:
        """Serve ``rate_tokens_per_sec`` (offered tokens/sec per trace
        hour) for ``hours`` trace hours under revocations. With
        ``sizing="auto"`` the demand-driven loop runs instead."""
        if self.sizing == "auto":
            return self._run_auto(hours, rate_tokens_per_sec)
        wl, policy, ov = self.workload, self.policy, self.ov
        rec = obs_current()
        if rec.enabled:
            rec.emit(
                obs_ev.RunStart(
                    t=0.0,
                    subsystem="fleet",
                    label=f"{self.mode}/static",
                    horizon_hours=float(hours),
                )
            )
            rec.emit(obs_ev.price_trace(0.0, self.future.prices))
        bd = Breakdown()
        price = PriceTable(self.future.prices)
        if self.mode == "fleet":
            plan = provision_fleet(
                wl, self.feats, policy, rate_correction=self._corr
            )
        else:
            plan = self._provision_static(set())
        revocations = repairs = 0
        migrated = restored = 0
        markets_used: List[int] = list(plan.markets)
        n_provisioned = len(plan.replicas)
        revoked: Set[int] = set()

        # live set: (replica, provisioned_at, live_from, session). Sessions
        # stay open until the replica dies or the simulation ends;
        # billing-cycle anchors stagger at each replica's own provisioning
        # instant. The capacity timeline is built from (time, delta) pairs
        # and prefix-summed after sorting — a replica revoked before its
        # startup completes cancels its own pending capacity exactly.
        live: List[Tuple[Replica, float, float, Session]] = []
        cap_deltas: List[Tuple[float, float]] = []

        def start_replica(
            rep: Replica,
            at: float,
            mig: Optional[MigrationCost] = None,
            restore_hours: float = 0.0,
        ):
            # one session per replica tenure, anchored (whole-hour cycles
            # and all) at its own provisioning instant — replicas bill on
            # naturally staggered clocks. ``mig`` is the fleet policy's
            # live migration (reshard wire time + re-prefill recompute);
            # ``restore_hours`` is the static baseline's full-state pull
            # through remote storage, billed to ``recovery`` like every
            # other storage restore in the repo.
            s = Session(
                rep.allocation.legs[0].market, at, legs=rep.allocation.markets
            )
            s.add("startup", ov.startup_hours)
            delay = ov.startup_hours
            if mig is not None:
                s.add("reshard", mig.wire_hours)
                s.add("re_execution", mig.recompute_hours)
                delay += mig.hours
            if restore_hours > 0:
                s.add("recovery", restore_hours)
                delay += restore_hours
            # a tracker-backed correction is already in the provisioned
            # rate (self._corr); re-derive it here only on the legacy
            # tracker-less path, where it is exactly 1.0
            corr = (
                1.0
                if self._corr is not None
                else self._rate_correction(rep.allocation)
            )
            rate = rep.tokens_per_sec * corr
            if rec.enabled:
                rec.emit(
                    obs_ev.Provision(
                        t=at,
                        market_id=int(rep.allocation.legs[0].market),
                        legs=tuple(int(m) for m in rep.allocation.markets),
                        replica_id=int(rep.replica_id),
                        rate_tokens_per_sec=rate,
                    )
                )
                if mig is not None:
                    rec.emit(obs_ev.ReshardStart(t=at, bytes_moved=int(mig.moved_bytes)))
                    rec.emit(obs_ev.ReshardDone(t=at + mig.wire_hours, hours=mig.wire_hours))
            live.append(
                (dataclasses.replace(rep, tokens_per_sec=rate), at, at + delay, s)
            )
            cap_deltas.append((at + delay, rate))

        for rep in plan.replicas:
            start_replica(rep, 0.0, None)

        # -- event loop: earliest next revocation among live replicas ----
        for _ in range(10_000):
            nxt: Optional[Tuple[int, int, int]] = None  # (hour, idx, market)
            for i, (rep, t0, _, _) in enumerate(live):
                h = self._next_revocation_hour(rep.allocation, t0)
                if h is not None and h < hours and (nxt is None or h < nxt[0]):
                    m = next(
                        m for m in rep.allocation.markets if self._rev[m, h]
                    )
                    nxt = (h, i, m)
            if nxt is None:
                break
            h, i, rev_market = nxt
            rep, t0, t_live, session = live.pop(i)
            revocations += 1
            revoked.add(rev_market)
            if rec.enabled:
                rec.emit(
                    obs_ev.Revoke(
                        t=float(h),
                        market_id=int(rev_market),
                        replica_id=int(rep.replica_id),
                    )
                )
            # the dead replica served until the revocation hour; its
            # tenure ends there and its own cycles settle (whole-hour
            # billing per spot request — same proxy as the batch paper)
            session.add("execution", max(h - t0 - session.used_hours, 0.0))
            if rec.enabled:
                rec.emit(obs_ev.session_billed(float(h), session))
            bill_session(session, price, bd)
            # capacity leaves when the replica dies — or never arrives, if
            # it died mid-startup (the -delta lands on the +delta's time)
            cap_deltas.append((max(float(h), t_live), -rep.tokens_per_sec))
            # survivors absorb the load (the router sees the capacity
            # dip); a replacement migrates in params-only
            survivors = [m for r, _, _, _ in live for m in r.allocation.markets]
            if self.mode == "fleet":
                newrep = repair_fleet(
                    wl, self.feats, policy,
                    revoked_market=rev_market,
                    survivors=survivors,
                    exclude=revoked,
                    lost=rep,
                    rate_correction=self._corr,
                )
                if newrep is not None:
                    mig = migration_cost(
                        param_bytes=wl.param_bytes,
                        cache_bytes=wl.cache_bytes,
                        cache_policy=policy.cache_policy,
                        dcn_gbps=newrep.allocation.dcn_gbps,
                        inflight_context_tokens=wl.inflight_context_tokens,
                        prefill_tokens_per_sec=wl.prefill_rate
                        * alg.allocation_throughput(newrep.allocation, self.feats),
                    )
                    migrated += mig.moved_bytes
                    repairs += 1
                    n_provisioned += 1
                    markets_used.extend(newrep.allocation.markets)
                    start_replica(newrep, float(h), mig)
            else:
                # static baseline: full serving state back through storage
                newplan = None
                try:
                    newplan = self._provision_static(
                        revoked | {m for m in survivors}
                    )
                except ValueError:
                    pass
                if newplan is not None and newplan.replicas:
                    newrep = dataclasses.replace(
                        newplan.replicas[0], replica_id=rep.replica_id
                    )
                    restored += wl.param_bytes + wl.cache_bytes
                    repairs += 1
                    n_provisioned += 1
                    markets_used.extend(newrep.allocation.markets)
                    start_replica(
                        newrep, float(h),
                        restore_hours=ov.restore_hours(wl.state_gb),
                    )

        # -- drain to the end of the window, settle every open session ---
        for _rep, t0, _, session in live:
            session.add("execution", max(hours - t0 - session.used_hours, 0.0))
            if rec.enabled:
                rec.emit(obs_ev.session_billed(float(hours), session))
            bill_session(session, price, bd)

        # prefix-sum the sorted deltas into the absolute-capacity timeline
        cap_events: List[CapacityEvent] = [CapacityEvent(0.0, 0.0)]
        level = 0.0
        for at, delta in sorted(cap_deltas):
            level += delta
            cap_events.append(CapacityEvent(at, max(level, 0.0)))

        stats = route_trace(
            rate_tokens_per_sec,
            cap_events,
            max_delay_seconds=policy.max_delay_seconds,
            shed_delay_seconds=policy.shed_delay_seconds,
            hours=hours,
        )
        stats.merge_into(bd)
        bd.revocations = revocations
        bd.wall_time = float(hours)
        if rec.enabled:
            rec.emit(obs_ev.breakdown_pin(float(hours), bd))
            rec.emit(obs_ev.RunEnd(t=float(hours), wall_hours=float(hours)))
        return FleetReport(
            breakdown=bd,
            router=stats,
            revocations=revocations,
            repairs=repairs,
            migrated_bytes=migrated,
            restored_bytes=restored,
            replicas_provisioned=n_provisioned,
            markets_used=markets_used,
            capacity_tokens_per_sec=plan.capacity_tokens_per_sec,
            relaxed_correlation=plan.relaxed_correlation,
            idle_headroom_tokens=idle_headroom_tokens(
                rate_tokens_per_sec, cap_events, hours=hours
            ),
        )

    # -- demand-driven sizing (the autoscaler loop) ----------------------
    def _run_auto(
        self,
        hours: float,
        rate_tokens_per_sec: Sequence[float],
    ) -> FleetReport:
        """Hour-driven demand loop: every trace hour the scaler forecasts
        the offered load, and the fleet is resized against the SAME bars
        ``provision_fleet`` enforces — scale-up ahead of ramps (never
        cooldown-gated), scale-down of the worst $/token replicas under
        the low-water mark (cooldown-gated, floored at the live offered
        rate and ``min_replicas``), and demand-driven repair: a revoked
        replica is replaced only when the survivors no longer clear the
        current target. Billing, migration pricing, and routing reuse the
        static loop's primitives unchanged — a scale-up replica is a
        params-only wire migration from the survivors (no in-flight
        contexts to re-prefill: it joins empty), a scale-down settles the
        retiree's session at the decision instant, and its in-flight
        streams drain to the survivors (``autoscale.drain_replica`` is
        the engine-level form, token-identical by the shed→resume pin).
        """
        wl, policy, ov = self.workload, self.policy, self.ov
        rec = obs_current()
        if rec.enabled:
            rec.emit(
                obs_ev.RunStart(
                    t=0.0,
                    subsystem="fleet",
                    label=f"{self.mode}/auto",
                    horizon_hours=float(hours),
                )
            )
            rec.emit(obs_ev.price_trace(0.0, self.future.prices))
        bd = Breakdown()
        price = PriceTable(self.future.prices)
        scaler = AutoScaler(
            self.autoscale,
            capacity_headroom=policy.capacity_headroom,
            survive_one_loss=policy.survive_one_loss,
        )
        revocations = repairs = 0
        migrated = restored = 0
        markets_used: List[int] = []
        n_provisioned = 0
        relaxed = False
        peak_capacity = 0.0
        revoked: Set[int] = set()
        next_id = 0

        live: List[Tuple[Replica, float, float, Session]] = []
        cap_deltas: List[Tuple[float, float]] = []

        def start_replica(rep: Replica, at: float, mig: Optional[MigrationCost]):
            nonlocal next_id, n_provisioned
            s = Session(
                rep.allocation.legs[0].market, at, legs=rep.allocation.markets
            )
            s.add("startup", ov.startup_hours)
            delay = ov.startup_hours
            if mig is not None:
                s.add("reshard", mig.wire_hours)
                s.add("re_execution", mig.recompute_hours)
                delay += mig.hours
            rep = dataclasses.replace(rep, replica_id=next_id)
            next_id += 1
            n_provisioned += 1
            markets_used.extend(rep.allocation.markets)
            if rec.enabled:
                rec.emit(
                    obs_ev.Provision(
                        t=at,
                        market_id=int(rep.allocation.legs[0].market),
                        legs=tuple(int(m) for m in rep.allocation.markets),
                        replica_id=int(rep.replica_id),
                        rate_tokens_per_sec=rep.tokens_per_sec,
                    )
                )
                if mig is not None:
                    rec.emit(obs_ev.ReshardStart(t=at, bytes_moved=int(mig.moved_bytes)))
                    rec.emit(obs_ev.ReshardDone(t=at + mig.wire_hours, hours=mig.wire_hours))
            live.append((rep, at, at + delay, s))
            cap_deltas.append((at + delay, rep.tokens_per_sec))

        def settle_replica(idx: int, at: float) -> Replica:
            rep, t0, t_live, session = live.pop(idx)
            session.add("execution", max(at - t0 - session.used_hours, 0.0))
            if rec.enabled:
                rec.emit(obs_ev.session_billed(at, session))
            bill_session(session, price, bd)
            # capacity leaves at the decision instant — or never arrives,
            # if the replica dies mid-startup
            cap_deltas.append((max(at, t_live), -rep.tokens_per_sec))
            return rep

        def scale_up(at: float, target: float, extra_exclude: Set[int]) -> bool:
            nonlocal migrated, relaxed
            wl_t = dataclasses.replace(wl, target_tokens_per_sec=target)
            holding = [r for r, _, _, _ in live]
            try:
                plan = provision_fleet(
                    wl_t, self.feats, policy,
                    exclude=revoked | extra_exclude,
                    existing=holding,
                    rate_correction=self._corr,
                )
            except ValueError:
                return False  # pool starved: best effort, router bills it
            for newrep in plan.replicas:
                mig = None
                if live:
                    # survivors hold the params: a new replica is a
                    # params-only wire migration; it joins with no
                    # in-flight contexts, so nothing is re-prefilled
                    mig = migration_cost(
                        param_bytes=wl.param_bytes,
                        cache_bytes=0,
                        cache_policy="drop",
                        dcn_gbps=newrep.allocation.dcn_gbps,
                    )
                    migrated += mig.moved_bytes
                start_replica(newrep, at, mig)
            relaxed = relaxed or plan.relaxed_correlation
            return bool(plan.replicas)

        def scale_down(at: float, target: float) -> bool:
            def dollars_per_token(rep: Replica) -> float:
                return alg.allocation_price(rep.allocation, self.feats) / max(
                    rep.tokens_per_sec, 1e-9
                )

            retired = False
            while len(live) > self.autoscale.min_replicas:
                idx = max(
                    range(len(live)),
                    key=lambda i: (
                        dollars_per_token(live[i][0]),
                        live[i][0].allocation.markets,
                    ),
                )
                trial = [
                    r.tokens_per_sec
                    for j, (r, _, _, _) in enumerate(live)
                    if j != idx
                ]
                if not scaler.satisfied(trial, target):
                    break
                settle_replica(idx, at)
                retired = True
            return retired

        # initial fleet, sized to hour 0's forecast (a cold start has no
        # survivors to migrate params from)
        fc0 = scaler.forecast(rate_tokens_per_sec, 0)
        offered0 = (
            float(rate_tokens_per_sec[0]) if len(rate_tokens_per_sec) else 0.0
        )
        target0 = max(fc0, offered0)
        scale_up(0.0, target0, self._revoking_at(0))
        scaler.record(0.0, "init")  # arms the cooldown, not a scale event

        # offered-rate lookups batched once: the hourly loop reads a plain
        # float array instead of converting a sequence element per hour
        offered = np.asarray(rate_tokens_per_sec, dtype=float)
        n_hours = int(hours)
        # sanctioned hourly DECISION loop: the scaler's verdict is
        # genuinely sequential (cooldowns, in-flight floor); the per-hour
        # trace lookups it consumes are precomputed arrays/maps
        for h in range(n_hours):  # repro-lint: disable=V001
            now = float(h)
            # 1) revocations landing this hour (same trace semantics as
            # the static loop: market m revokes at hour h)
            revoking = self._revoking_at(h)
            for i in reversed(range(len(live))):
                rep = live[i][0]
                hit = [m for m in rep.allocation.markets if m in revoking]
                if hit:
                    if rec.enabled:
                        rec.emit(
                            obs_ev.Revoke(
                                t=now,
                                market_id=int(hit[0]),
                                replica_id=int(rep.replica_id),
                            )
                        )
                    settle_replica(i, now)
                    revocations += 1
                    revoked.update(hit)
            # 2) the scaler's verdict for this interval
            offered_now = (
                float(offered[min(h, offered.size - 1)]) if offered.size else 0.0
            )
            fc = scaler.forecast(rate_tokens_per_sec, h)
            live_rates = [r.tokens_per_sec for r, _, _, _ in live]
            decision = scaler.decide(
                now,
                live_rates,
                forecast=fc,
                offered_now=offered_now,
            )
            if rec.enabled:
                # the scaler's full input vector, so a trace answers "what
                # did it see when it scaled" without rerunning the fleet
                rec.emit(
                    obs_ev.ScaleDecision(
                        t=now,
                        kind=decision.kind,
                        offered_tokens_per_sec=offered_now,
                        forecast_tokens_per_sec=fc,
                        capacity_tokens_per_sec=sum(live_rates),
                        target_tokens_per_sec=decision.target_tokens_per_sec,
                    )
                )
            if decision.kind == "up":
                # demand-driven repair and ramp scale-up are the same
                # move: add capacity until the bars clear again
                n_before = len(live)
                grew = scale_up(
                    now, decision.target_tokens_per_sec, revoking
                )
                if grew:
                    if rec.enabled:
                        rec.emit(
                            obs_ev.ScaleUp(
                                t=now,
                                added=len(live) - n_before,
                                target_tokens_per_sec=decision.target_tokens_per_sec,
                            )
                        )
                    if revoking:
                        repairs += 1
                    scaler.record(now, "up")
            elif decision.kind == "down":
                n_before = len(live)
                if scale_down(now, decision.target_tokens_per_sec):
                    if rec.enabled:
                        rec.emit(
                            obs_ev.ScaleDown(
                                t=now,
                                retired=n_before - len(live),
                                target_tokens_per_sec=decision.target_tokens_per_sec,
                            )
                        )
                    scaler.record(now, "down")
            peak_capacity = max(
                peak_capacity, sum(r.tokens_per_sec for r, _, _, _ in live)
            )

        # drain to the end of the window, settle every open session
        for _rep, t0, _, session in live:
            session.add("execution", max(hours - t0 - session.used_hours, 0.0))
            if rec.enabled:
                rec.emit(obs_ev.session_billed(float(hours), session))
            bill_session(session, price, bd)

        cap_events: List[CapacityEvent] = [CapacityEvent(0.0, 0.0)]
        level = 0.0
        for at, delta in sorted(cap_deltas):
            level += delta
            cap_events.append(CapacityEvent(at, max(level, 0.0)))

        stats = route_trace(
            rate_tokens_per_sec,
            cap_events,
            max_delay_seconds=policy.max_delay_seconds,
            shed_delay_seconds=policy.shed_delay_seconds,
            hours=hours,
        )
        stats.merge_into(bd)
        bd.revocations = revocations
        bd.wall_time = float(hours)
        if rec.enabled:
            rec.emit(obs_ev.breakdown_pin(float(hours), bd))
            rec.emit(obs_ev.RunEnd(t=float(hours), wall_hours=float(hours)))
        return FleetReport(
            breakdown=bd,
            router=stats,
            revocations=revocations,
            repairs=repairs,
            migrated_bytes=migrated,
            restored_bytes=restored,
            replicas_provisioned=n_provisioned,
            markets_used=markets_used,
            capacity_tokens_per_sec=peak_capacity,
            relaxed_correlation=relaxed,
            scale_ups=scaler.scale_ups,
            scale_downs=scaler.scale_downs,
            idle_headroom_tokens=idle_headroom_tokens(
                rate_tokens_per_sec, cap_events, hours=hours
            ),
        )

    def _revoking_at(self, hour: int) -> Set[int]:
        """Markets whose spot request is revoked at trace hour ``hour`` —
        excluded from same-hour provisioning (a replica placed on one
        would die before it finished starting). O(1) map lookup; quiet
        hours (the vast majority) return the empty set without touching
        the revocation matrix."""
        return self._rev_hours.get(int(hour), set())


def on_demand_reference(
    workload: ServingWorkload,
    feats: alg.MarketFeatures,
    future: MarketSet,
    hours: float,
    rate_tokens_per_sec: Sequence[float],
    policy: ServePolicy,
    overheads: OverheadModel = OverheadModel(),
) -> FleetReport:
    """The on-demand baseline: replicas on the fitting shape with the best
    on-demand $ per delivered token, no revocations ever, billed at the
    sticker price for the whole window. The availability bar the fleet
    policy must match at lower cost."""
    job = Job(length_hours=policy.slo_horizon_hours, memory_gb=workload.state_gb)
    fit = alg.find_suitable_servers(job, feats)
    if not fit:
        raise ValueError("on-demand: no shape fits the replica")
    best = min(
        fit,
        key=lambda i: (
            float(feats.on_demand[i])
            / max(
                replica_rate(workload, feats, Allocation.single(i, 1)), 1e-9
            ),
            i,
        ),
    )
    alloc = Allocation.single(best, int(feats.device_count[best]))
    rate = replica_rate(workload, feats, alloc)
    target = workload.target_tokens_per_sec * policy.capacity_headroom
    k = max(int(math.ceil(target / max(rate, 1e-9))), 1)
    rec = obs_current()
    if rec.enabled:
        rec.emit(
            obs_ev.RunStart(
                t=0.0,
                subsystem="fleet",
                label="on_demand",
                horizon_hours=float(hours),
            )
        )
    bd = Breakdown()
    od_price = float(feats.on_demand[best])
    od_table = PriceTable.constant(od_price)
    for i in range(k):
        s = Session(best, 0.0)
        s.add("startup", overheads.startup_hours)
        s.add("execution", max(hours - overheads.startup_hours, 0.0))
        if rec.enabled:
            rec.emit(
                obs_ev.Provision(
                    t=0.0,
                    market_id=int(best),
                    legs=(int(best),),
                    replica_id=i,
                    rate_tokens_per_sec=rate,
                )
            )
            rec.emit(obs_ev.session_billed(0.0, s, price_const=od_price))
        bill_session(s, od_table, bd)
    cap_events = [
        CapacityEvent(0.0, 0.0),
        CapacityEvent(overheads.startup_hours, k * rate),
    ]
    stats = route_trace(
        rate_tokens_per_sec,
        cap_events,
        max_delay_seconds=policy.max_delay_seconds,
        shed_delay_seconds=policy.shed_delay_seconds,
        hours=hours,
    )
    stats.merge_into(bd)
    bd.wall_time = float(hours)
    if rec.enabled:
        rec.emit(obs_ev.breakdown_pin(float(hours), bd))
        rec.emit(obs_ev.RunEnd(t=float(hours), wall_hours=float(hours)))
    return FleetReport(
        breakdown=bd,
        router=stats,
        revocations=0,
        repairs=0,
        migrated_bytes=0,
        restored_bytes=0,
        replicas_provisioned=k,
        markets_used=[best] * k,
        capacity_tokens_per_sec=k * rate,
        idle_headroom_tokens=idle_headroom_tokens(
            rate_tokens_per_sec, cap_events, hours=hours
        ),
    )
