"""SpotTrainingOrchestrator — the paper's provisioner driving the port's
training run (port of ``repro.core.orchestrator``).

The execution substrate (models, train step, checkpoint manager) is the
port's own; the provisioning layer decides WHERE each work segment runs and
what happens on a spot revocation. The constructor, arguments, report
fields, event stream and accounting are the reference's; where the
reference takes a JAX mesh, this one takes the ``device`` its pool of
slots names, or a ``mesh_manager`` over a pool (eight slots on one card
simulate an 8-device instance: placements decide the byte accounting,
execution is on the one device).

Three places differ from the reference, because the port's train step
updates params and moments IN PLACE (``repro_torch.optim.adamw``) where
JAX arrays are immutable:

* a segment that a revocation will cut after at least one step first
  copies its start state to host memory (``OrchestratorReport.snapshots``
  logs its bytes and seconds; nothing bills it). The reference hands the
  untouched segment-start arrays to the next market; here that copy is
  written back, since the tensors themselves have moved on;
* a fresh state comes from ``init_state`` (default: the port's
  ``init_train_state`` from ``tc.seed``), called anew each time;
* a checkpoint restores onto the plan's device.

* ``mode="siwoft"``      — Algorithm 1 picks the market (highest MTTR ≥ 2×
  the segment's expected duration); NO checkpoints are written. On a
  revocation the current segment's steps are lost and re-executed on a new
  low-correlation market. Completed segments survive: their state lives on
  the (new) instance via in-memory handoff — job-queue semantics, not a
  fault-tolerance mechanism.
* ``mode="checkpoint"``  — FT baseline: random suitable market, periodic
  checkpoints through :class:`CheckpointManager`; revocation → restore the
  last checkpoint (recovery time) and re-execute the delta.
* ``mode="hybrid"``      — beyond-paper: Algorithm-1 market selection AND
  coarse checkpoints (what you actually want for week-long pretraining).

Instance-menu deviation (beyond the paper): every market is a *mesh shape*
(``device_count`` × ``memory_gb``, ``interconnect_gbps`` — see
``repro_torch.core.market.InstanceShape``), and the job's memory requirement is
the model's real param+optimizer footprint (``dist.meshplan.
train_state_bytes``), not a hard-coded class. When provisioning lands on a
market whose shape differs from the one the live state sits on, siwoft/
hybrid migrate by a LIVE CROSS-MESH RESHARD: the ``TrainState`` moves
leaf-by-leaf onto the new market's slots (``dist.elastic.reshard_tree``),
a step is built for the new plan, and training continues — no
checkpoint touched. The reshard cost model: ``reshard_bytes`` (slice-
overlap bytes actually moved, ``dist.meshplan.reshard_bytes``) over the
destination market's interconnect, billed to the ``reshard`` time/cost
component so Fig-1-style breakdowns show reshard vs recovery vs
re-execution head-to-head. The checkpoint baseline instead pays
``recovery`` (full state through remote storage) and its moved bytes are
reported as ``restore_bytes`` — the byte-level comparison the paper's
thesis needs.

Throughput deviation (beyond the paper): each market's shape carries a
relative throughput (``repro_torch.core.market.shape_throughput`` — sublinear in
device count), so ``steps_per_trace_hour`` is the 1-device REFERENCE rate
and a provisioned market delivers ``steps_per_trace_hour × θ`` steps per
trace hour. Provisioning ranks by expected cost-to-complete (price
integrated over the shape-dependent wall time) rather than raw $/h, so
siwoft deliberately migrates to a bigger, pricier shape when it finishes
the remaining work cheaper. The orchestrator also MEASURES real steps/sec
per mesh shape from ``run_segment`` wall timings (``ThroughputTracker``)
and corrects the analytic model with the observed ratios on every
subsequent pick; the report carries the measured per-shape rates
(``shape_steps_per_hour``) and the first pick's expected
``cost_to_complete``.

Allocation deviation (beyond the paper): the unit of provisioning is a
multi-leg ``repro_torch.core.allocation.Allocation``. A job
whose footprint fits no single menu shape splits across up to
``policy.max_legs`` markets: the legs form ONE mesh
(``ElasticMeshManager.plan_for_allocation`` — contiguous per-leg device
spans on the slot pool), billed per leg at each market's own price
(``Breakdown.leg_cost`` sums exactly to the total), running at the
DCN-discounted combined throughput. A revocation of ONE leg is a PARTIAL
reshard: the surviving legs keep their shards, the provisioner swaps only
the lost leg for a same-shape low-correlation market
(``_pick_allocation_siwoft(repair_of=...)``), and the bill is the lost
leg's distinct state slices over DCN (``dist.meshplan.leg_state_bytes``)
— strictly fewer bytes than the full restore a checkpoint baseline pays.
Single-leg allocations reproduce the pre-allocation orchestrator
bit-exactly.

Revocations: siwoft/hybrid markets revoke when their future price trace
crosses on-demand (mapped trace-hour → step index at the shape's step
rate); the FT baseline gets the paper's fixed injected revocation count.
Costs accrue per billing cycle against the market's trace price with an
explicit monotone wall clock that advances at the shape-dependent rate.
"""
from __future__ import annotations

import dataclasses
import math
import time
from typing import Any, Callable, Dict, List, Optional, Set, Tuple

import numpy as np
import torch

from repro_torch import resolve_device
from repro_torch.ckpt import CheckpointManager
from repro_torch.config.base import ShardingLayout, TrainConfig
from repro_torch.core import provisioner as alg
from repro_torch.core.accounting import (
    Breakdown,
    PriceTable,
    Session,
    bill_session,
    settle_leg,
)
from repro_torch.core.allocation import Allocation, Leg
from repro_torch.core.market import (
    THROUGHPUT_EFFICIENCY_CEIL,
    MarketSet,
    shape_throughput,
)
from repro_torch.core.policies import Job, OverheadModel, SiwoftPolicy
from repro_torch.core.units import BYTES_PER_GIB, SECONDS_PER_HOUR
from repro_torch.data import SyntheticLM
from repro_torch.dist.elastic import placement_device, reshard_tree
from repro_torch.dist.meshplan import (
    ElasticMeshManager,
    MeshPlan,
    ThroughputTracker,
    leg_state_bytes,
    reshard_bytes,
    train_state_bytes,
    tree_bytes,
)
from repro_torch.dist.sharding import param_shardings, replicated
from repro_torch.models import zoo
from repro_torch.models.common import tree_flatten
from repro_torch.obs import events as obs_ev
from repro_torch.obs.recorder import current as obs_current
from repro_torch.optim import OptState
from repro_torch.train.loop import Revoked, make_step, run_segment
from repro_torch.train.steps import TrainState, init_train_state


@dataclasses.dataclass
class OrchestratorReport:
    total_steps: int
    useful_steps: int
    wasted_steps: int
    revocations: int
    markets_used: List[int]
    cost_dollars: float
    wall_seconds: float
    losses: List[float]
    # byte-level migration accounting (beyond the paper)
    reshard_bytes: int = 0          # bytes moved by live cross-mesh reshards
    restore_bytes: int = 0          # bytes pulled through checkpoint restores
    reshard_events: int = 0         # migrations that moved live state
    mesh_shapes: List[Tuple[int, int]] = dataclasses.field(default_factory=list)
    breakdown: Optional[Breakdown] = None
    # throughput accounting (beyond the paper): measured steps/hour per mesh
    # shape ("DxM" -> steps/hour, from run_segment wall timings) and the
    # expected $ cost-to-complete of the first provisioned market — the
    # quantity the provisioner ranked by (price/throughput over the work,
    # risk-adjusted), as opposed to that market's raw $/h
    shape_steps_per_hour: Dict[str, float] = dataclasses.field(default_factory=dict)
    cost_to_complete: float = 0.0
    # multi-leg allocation accounting (beyond the paper): the leg tuple of
    # every provisioned allocation (singletons for one-market picks), the
    # per-market dollar split of cost_dollars (must sum to it — pinned by
    # tests/test_allocation.py), and how many revocations were repaired by
    # rebuilding ONE leg over DCN instead of a full re-provision
    allocations_used: List[Tuple[int, ...]] = dataclasses.field(default_factory=list)
    leg_costs: Dict[int, float] = dataclasses.field(default_factory=dict)
    leg_repairs: int = 0
    # the port's own, measured on the host and not part of any bill: each
    # segment-start snapshot (bytes, seconds to take it, seconds to write
    # it back or None) and each provisioning decision's seconds
    snapshots: List[Dict[str, Any]] = dataclasses.field(default_factory=list)
    decision_seconds: List[float] = dataclasses.field(default_factory=list)

    @property
    def goodput(self) -> float:
        return self.useful_steps / max(self.total_steps, 1)


class SpotTrainingOrchestrator:
    def __init__(
        self,
        model: zoo.Model,
        dataset: SyntheticLM,
        device,
        history: MarketSet,
        future: MarketSet,
        *,
        mode: str = "siwoft",
        tc: TrainConfig = TrainConfig(),
        layout: ShardingLayout = ShardingLayout(attn_impl="flash"),
        segment_steps: int = 20,
        steps_per_trace_hour: int = 50,
        ckpt_dir: Optional[str] = None,
        ckpt_every: int = 10,
        ft_revocations: int = 2,
        seed: int = 0,
        overheads: OverheadModel = OverheadModel(),
        mesh_manager: Optional[ElasticMeshManager] = None,
        policy: Optional[SiwoftPolicy] = None,
        job_memory_gb: Optional[float] = None,
        init_state: Optional[Callable[[], TrainState]] = None,
    ):
        assert mode in ("siwoft", "checkpoint", "hybrid")
        self.model = model
        self.dataset = dataset
        # ``device`` is the pool the menu shapes are built from when no
        # ``mesh_manager`` is given (one slot); the plan per segment comes
        # from the provisioned market's device_count
        self.device = resolve_device(device)
        self.meshman = mesh_manager or ElasticMeshManager([self.device])
        # a fresh train state, anew on every call (the run's start, and a
        # checkpoint-mode revocation before any checkpoint)
        self._init_state = init_state or (lambda: init_train_state(
            model, torch.Generator(device=self.device).manual_seed(tc.seed), self.device))
        self.mode = mode
        self.tc = tc
        self.layout = layout
        self.segment_steps = segment_steps
        self.steps_per_hour = steps_per_trace_hour
        self.ft_revocations = ft_revocations
        self.seed = seed
        self.ov = overheads
        self.feats = alg.MarketFeatures.from_history(history)
        self.future = future
        self._rev = future.revocation_matrix()
        self.ckpt = (
            CheckpointManager(ckpt_dir, keep=3)
            if ckpt_dir and mode in ("checkpoint", "hybrid")
            else None
        )
        self.ckpt_every = ckpt_every
        self.policy = policy or SiwoftPolicy()
        # planner-level footprint override (GB): lets a run exercise the
        # multi-leg split path (a footprint larger than every menu shape)
        # while the local device pool keeps simulating the execution — the
        # reduced model's real bytes still drive the reshard accounting
        self.job_memory_gb = job_memory_gb
        # one step + state-placement tree per distinct mesh plan
        self._steps: Dict[Tuple, Tuple[Any, Any]] = {}
        # measured steps/sec per mesh-plan key (EMA) + the analytic
        # prediction for each honored shape — the correction of the menu's
        # throughput model by what run_segment actually delivered
        self.thr_tracker = ThroughputTracker()
        self._analytic_honored: Dict[Tuple, float] = {}

    # ------------------------------------------------------------------
    def _segment_job(self, total_steps: int) -> Job:
        # length in WORK hours: steps at the 1-device reference rate; a
        # provisioned shape with throughput θ delivers θ × steps_per_hour
        hours = total_steps / self.steps_per_hour
        # real footprint: fp32 params + both Adam moments, from the model's
        # ParamSpec tree via the dist layer (was: hard-coded 16 GB) — unless
        # the planner-level override stands in for a bigger production model
        mem_gb = (
            self.job_memory_gb
            if self.job_memory_gb is not None
            else train_state_bytes(self.model) / BYTES_PER_GIB
        )
        return Job(length_hours=hours, memory_gb=mem_gb, job_id=0)

    def _jitted_for(self, plan: MeshPlan):
        """(step, state placements) for ``plan``: the reference's
        ``make_jitted_step`` placements (params and both moments by the
        param rules, ``count`` and ``step`` replicated)."""
        entry = self._steps.get(plan.key)
        if entry is None:
            p_sh = param_shardings(self.model.specs, plan.mesh, self.layout)
            repl = replicated(plan.mesh)
            state_sh = TrainState(
                params=p_sh, opt=OptState(m=p_sh, v=p_sh, count=repl), step=repl
            )
            entry = (make_step(self.model, self.tc, self.layout), state_sh)
            self._steps[plan.key] = entry
        return entry

    def _plan_key_for(self, market: int) -> Tuple:
        plan = self.meshman.plan_for(self.future.markets[market].device_count)
        if plan.key not in self._analytic_honored:
            self._analytic_honored[plan.key] = shape_throughput(plan.device_count)
        return plan.key

    def _effective_feats(self) -> alg.MarketFeatures:
        """Menu features with the throughput column calibrated by measured
        per-shape step rates: analytic model × measured-vs-analytic
        correction for the market's (honored) mesh shape. Until two
        distinct shapes have been timed the correction is 1.0 and the
        analytic model stands."""
        thr = np.array(self.feats.throughput, dtype=float, copy=True)
        for i, m in enumerate(self.future.markets):
            if m.steps_per_hour is not None:
                # an explicit measured rate in the trace is ground truth:
                # neither the local-pool correction nor the analytic
                # ceiling applies to it
                continue
            key = self._plan_key_for(i)
            thr[i] *= self.thr_tracker.correction(key, self._analytic_honored)
            # the correction is anchored on the local pool's honored shapes
            # (default-bandwidth exponent), while the analytic value it
            # scales is bandwidth-aware — cap the product at the model's
            # sublinear ceiling so no calibration can claim superlinear
            # scaling
            cap = float(self.feats.device_count[i]) ** THROUGHPUT_EFFICIENCY_CEIL
            thr[i] = min(thr[i], cap)
        return dataclasses.replace(self.feats, throughput=thr)

    def _throughput_of(self, feats: alg.MarketFeatures, market: int) -> float:
        return max(float(feats.throughput[market]), 1e-9)

    def _pick_allocation_siwoft(
        self,
        job: Job,
        feats,
        revoked: Set[int],
        repair_of: Optional[Tuple[Allocation, int]] = None,
    ) -> Tuple[Allocation, bool]:
        """Algorithm 1 over allocations; returns (allocation, is_repair).

        ``repair_of = (interrupted_allocation, revoked_market)`` activates
        the partial-reshard path: before a full re-provision, try to swap
        ONLY the lost leg for a same-shape market that is low-correlated
        with the revoked market AND with every surviving leg. A repair
        keeps the mesh plan (and the live state's layout) intact, so the
        only migration bytes are the lost leg's distinct slices over DCN —
        strictly fewer than a full restore. When no repair admits, fall
        back to the ordinary allocation pick."""
        policy = self.policy
        if repair_of is not None and repair_of[0].is_split:
            prev, rev_market = repair_of
            lost = next(l for l in prev.legs if l.market == rev_market)
            surviving = tuple(m for m in prev.markets if m != rev_market)
            W = alg.find_low_correlation(
                feats, rev_market, policy, surviving=surviving
            )
            repairs = []
            for w in sorted(W):
                if w in revoked or w in prev.markets:
                    continue
                if int(feats.device_count[w]) != lost.device_count:
                    continue  # same shape class: the mesh plan survives
                cand = prev.replace_leg(rev_market, Leg(w, lost.device_count))
                if alg.allocation_memory_gb(cand, feats) < job.memory_gb:
                    continue
                if alg.allocation_mttr(cand, feats) >= (
                    policy.lifetime_factor
                    * alg.allocation_wall_hours(job.length_hours, feats, cand)
                ):
                    repairs.append(cand)
            if repairs:
                repairs.sort(
                    key=lambda a: (
                        alg.allocation_expected_cost_to_complete(
                            job.length_hours, feats, a
                        ),
                        a.markets,
                    )
                )
                return repairs[0], True
        suitable = [
            a
            for a in alg.find_suitable_allocations(job, feats, policy)
            if not any(m in revoked for m in a.markets)
        ]
        if not suitable:
            suitable = alg.find_suitable_allocations(job, feats, policy)
        if not suitable:
            raise ValueError(
                f"{job.memory_gb} GB fits no allocation of ≤{policy.max_legs} legs"
            )
        lifetimes = alg.compute_allocation_lifetimes(feats, suitable)
        S = alg.server_based_lifetime(job, lifetimes, policy, feats)
        return alg.highest(S), False

    def _pick_market_random(self, job: Job, feats, revoked: Set[int], salt: int) -> int:
        cands = [
            i for i in alg.find_suitable_servers(job, feats) if i not in revoked
        ]
        if not cands:
            cands = alg.find_suitable_servers(job, feats)
        if not cands:
            raise ValueError(
                f"FT baseline cannot provision {job.memory_gb} GB: no single "
                "menu shape fits (splitting is a no-FT allocation mechanism)"
            )
        rng = np.random.default_rng((self.seed, salt))
        return int(cands[rng.integers(len(cands))])

    def _revocation_step(
        self, market: int, from_step: int, wall: float, rate: float
    ) -> Optional[int]:
        """Map the market's next trace revocation (first trace hour ≥
        ``wall`` whose price crosses on-demand) to a global step index,
        at this market's shape-dependent step rate (steps per trace hour)."""
        h = int(math.ceil(wall))
        tail = self._rev[market, h:]
        if not tail.any():
            return None
        rev_hour = h + int(np.argmax(tail))
        return from_step + max(int((rev_hour - wall) * rate), 0)

    def _revocation_step_alloc(
        self, alloc: Allocation, from_step: int, wall: float, rate: float
    ) -> Tuple[Optional[int], Optional[int]]:
        """Earliest trace revocation across the allocation's legs, mapped to
        a global step index at the allocation's combined step rate; returns
        (step, revoked leg's market). Any leg revocation interrupts the
        whole allocation — the min-MTTR semantics the admission rule
        priced. Leg order breaks exact hour ties deterministically."""
        best_step: Optional[int] = None
        best_market: Optional[int] = None
        for m in alloc.markets:
            s = self._revocation_step(m, from_step, wall, rate)
            if s is not None and (best_step is None or s < best_step):
                best_step, best_market = s, m
        return best_step, best_market

    # ------------------------------------------------------------------
    def run(self, total_steps: int) -> OrchestratorReport:
        state = self._init_state()
        # the placement tree the live state is laid out by (torch tensors
        # carry none: the reference reads ``live_shardings(state)``)
        live_sh = None
        snapshots: List[Dict[str, Any]] = []
        decision_seconds: List[float] = []
        job = self._segment_job(total_steps)
        revoked: Set[int] = set()
        markets: List[int] = []
        allocations: List[Tuple[int, ...]] = []
        mesh_shapes: List[Tuple[int, int]] = []
        losses: List[float] = []
        bd = Breakdown()
        useful = wasted = revs = 0
        moved_total = 0
        restore_total = 0
        reshard_events = 0
        leg_repairs = 0
        first_ecc = 0.0
        active_key = None  # plan.key the live state is laid out for
        # a pending one-leg rebuild: (interrupted allocation, revoked
        # market) + the lost leg's distinct-slice bytes, measured at
        # revocation time and billed over DCN on the repaired session
        pending_repair: Optional[Tuple[Allocation, int]] = None
        pending_repair_bytes = 0
        # staggered billing cycles across a split revocation: surviving
        # legs defer their billing buffer (their occupancy continues into
        # the repaired session) — market -> (cycle anchor, deferred end
        # wall), settled when the leg is finally dropped or at run end
        carry_anchors: Dict[int, Tuple[float, float]] = {}
        # PriceTable routes bill_session through the vectorized biller;
        # identical to the spot_price closure call-for-call (same clamp)
        price_of = PriceTable(self.future.prices)
        step = 0
        wall = 0.0  # trace wall-clock hours; advances at the shape's rate
        rec = obs_current()
        if rec.enabled:
            rec.emit(
                obs_ev.RunStart(
                    t=wall,
                    subsystem="orchestrator",
                    label=self.mode,
                    horizon_hours=float(self.future.n_hours),
                )
            )
            rec.emit(obs_ev.price_trace(wall, self.future.prices))
        # real (not simulated) wall clock: measures actual segment speed for
        # the ThroughputTracker; never enters the deterministic trace ledger
        t0 = time.perf_counter()  # repro-lint: disable=D001

        # FT baseline: fixed injected revocation schedule (paper methodology)
        rng = np.random.default_rng((self.seed, 77))
        ft_rev_steps = (
            sorted(rng.integers(1, max(total_steps, 2), size=self.ft_revocations).tolist())
            if self.mode == "checkpoint"
            else []
        )

        while step < total_steps:
            # provisioning consults the measured-throughput-corrected menu:
            # after a segment on a shape, its real steps/sec feeds back into
            # the cost-to-complete ranking for every later pick
            t_pick = time.perf_counter()  # repro-lint: disable=D001
            feats = self._effective_feats()
            remaining = alg.remaining_job(job, (total_steps - step) / self.steps_per_hour)
            if self.mode in ("siwoft", "hybrid"):
                alloc, is_repair = self._pick_allocation_siwoft(
                    remaining, feats, revoked, repair_of=pending_repair
                )
            else:
                market = self._pick_market_random(
                    remaining, feats, revoked, salt=len(allocations)
                )
                alloc = Allocation.single(
                    market, self.future.markets[market].device_count
                )
                is_repair = False
            decision_seconds.append(
                time.perf_counter() - t_pick  # repro-lint: disable=D001
            )
            if not allocations:
                first_ecc = alg.allocation_expected_cost_to_complete(
                    job.length_hours, feats, alloc
                )
            allocations.append(alloc.markets)
            markets.extend(alloc.markets)
            m = self.future.markets[alloc.legs[0].market]
            plan = self.meshman.plan_for_allocation(alloc.device_counts)
            mesh_shapes.append(plan.mesh_shape)
            jitted, state_sh = self._jitted_for(plan)
            dev = placement_device(state_sh.step)
            # steps this allocation delivers per trace hour: reference rate ×
            # the (calibrated) relative throughput — for splits, the
            # DCN-discounted combined throughput over the union mesh
            rate = self.steps_per_hour * max(
                alg.allocation_throughput(alloc, feats), 1e-9
            )

            if rec.enabled:
                rec.emit(
                    obs_ev.Provision(
                        t=wall,
                        market_id=int(alloc.legs[0].market),
                        legs=tuple(int(m) for m in alloc.markets),
                    )
                )
            session = Session(alloc.legs[0].market, wall, legs=alloc.markets)
            if carry_anchors:
                # legs surviving the last split revocation carry their own
                # billing-cycle anchors into this session; carried legs
                # this allocation no longer holds settle their final
                # partial cycle now (leg-level billing-cycle staggering)
                session.leg_anchors = tuple(
                    carry_anchors.get(m, (wall,))[0] for m in alloc.markets
                )
                for m in list(carry_anchors):
                    if m in alloc.markets:
                        del carry_anchors[m]
                    else:
                        a, end = carry_anchors.pop(m)
                        if rec.enabled:
                            rec.emit(
                                obs_ev.LegSettled(
                                    t=wall, market_id=int(m), anchor=a, end_wall=end
                                )
                            )
                        settle_leg(bd, m, a, end, price_of)
            session.add("startup", self.ov.startup_hours)

            if pending_repair is not None and active_key == plan.key:
                prev_alloc, _ = pending_repair
                if is_repair:
                    # partial reshard: only the lost leg is rebuilt — its
                    # distinct state slices cross the DCN once; surviving
                    # legs keep their shards, the jitted step is reused
                    moved = pending_repair_bytes
                    leg_repairs += 1
                else:
                    # the ordinary pick replaced more than the lost leg
                    # (no same-shape repair admitted): every leg span whose
                    # market changed must be refilled over DCN — which is
                    # why this always costs at least as much as a repair
                    changed = [
                        i
                        for i in range(
                            min(len(alloc.legs), len(prev_alloc.legs))
                        )
                        if alloc.markets[i] != prev_alloc.markets[i]
                    ] + list(range(len(prev_alloc.legs), len(alloc.legs)))
                    moved = sum(
                        leg_state_bytes(state, state_sh, plan, i)
                        for i in changed
                        if i < len(plan.leg_spans)
                    )
                if moved:
                    moved_total += moved
                    reshard_events += 1
                    reshard_h = self.ov.reshard_hours(moved, alloc.dcn_gbps)
                    if rec.enabled:
                        rec.emit(
                            obs_ev.ReshardStart(
                                t=wall, bytes_moved=int(moved), gbps=alloc.dcn_gbps
                            )
                        )
                        rec.emit(obs_ev.ReshardDone(t=wall + reshard_h, hours=reshard_h))
                    session.add("reshard", reshard_h)
            pending_repair, pending_repair_bytes = None, 0

            # live cross-mesh migration: the state's current layout differs
            # from the provisioned market's mesh -> move it, price it
            if active_key != plan.key:
                if active_key is not None:
                    if self.mode in ("siwoft", "hybrid"):
                        moved = reshard_bytes(state, live_sh, state_sh)
                        moved_total += moved
                        reshard_events += 1
                        reshard_h = self.ov.reshard_hours(moved, m.interconnect_gbps)
                        if rec.enabled:
                            rec.emit(
                                obs_ev.ReshardStart(
                                    t=wall,
                                    bytes_moved=int(moved),
                                    gbps=m.interconnect_gbps,
                                )
                            )
                            rec.emit(
                                obs_ev.ReshardDone(t=wall + reshard_h, hours=reshard_h)
                            )
                        session.add("reshard", reshard_h)
                    else:
                        # the checkpoint baseline has no live-handoff
                        # mechanism: crossing instances means a checkpoint
                        # write + restore through remote storage, full
                        # state size (post-revocation restores skip this
                        # branch via active_key = None — already billed)
                        restore_total += tree_bytes(state)
                        session.add("recovery", self.ov.restore_hours(job.memory_gb))
                state = reshard_tree(state, state_sh)
                live_sh = state_sh
                active_key = plan.key

            if self.mode == "checkpoint":
                rev_at = ft_rev_steps[revs] if revs < len(ft_rev_steps) else None
                rev_market = alloc.legs[0].market if rev_at is not None else None
            else:
                rev_at, rev_market = self._revocation_step_alloc(
                    alloc, step, wall + session.used_hours, rate
                )

            seg_start = step
            seg_state = state
            n = min(self.segment_steps, total_steps - step)
            # The reference hands ``seg_state`` to the next market after a
            # revocation: its arrays are immutable, so they still hold the
            # segment's start. The port's step updates params and moments
            # in place, so once a step has run they no longer do. When the
            # revocation will cut this segment after at least one step and
            # the live state is what survives it (every mode but checkpoint
            # with a checkpoint manager), copy the start state to host
            # memory first; ``_write_back`` puts it back on ``Revoked``.
            snap = None
            if (
                rev_at is not None
                and seg_start < rev_at < seg_start + n
                and not (self.mode == "checkpoint" and self.ckpt is not None)
            ):
                snap = _snapshot(seg_state, seg_start)
                snapshots.append(snap)

            try:
                res = run_segment(
                    self.model, seg_state, self.dataset, dev,
                    self.tc,
                    self.layout,
                    num_steps=n,
                    start_step=step,
                    ckpt=self.ckpt,
                    ckpt_every=self.ckpt_every if self.mode in ("checkpoint", "hybrid") else 0,
                    revoke_at_step=(lambda s: rev_at is not None and s >= rev_at),
                    jitted=jitted,
                )
                state = res.state
                losses.extend(res.losses)
                useful += res.steps_done
                session.add("execution", res.steps_done / rate)
                step += res.steps_done
                # feed the measured step rate back into the throughput model
                self.thr_tracker.observe(
                    plan.key, res.steps_done, sum(res.step_seconds)
                )
            except Revoked as r:
                done = max(r.last_step - seg_start + 1, 0)
                revs += 1
                if rec.enabled:
                    rec.emit(obs_ev.Revoke(t=wall, market_id=int(rev_market)))
                revoked.add(rev_market)
                session.add("re_execution", done / rate)
                handoff = False  # true when live state survives in memory
                if self.mode == "checkpoint" and self.ckpt is not None:
                    self.ckpt.wait()
                    latest = self.ckpt.latest_step()
                    if latest is not None:
                        _, state = self.ckpt.restore(
                            latest, device=dev, like=seg_state
                        )
                        restore_total += tree_bytes(state)
                        step = latest
                    else:
                        state = self._init_state()
                        step = 0
                    # the restored state is host-materialized: it must be
                    # re-laid-out for whatever mesh the next market brings
                    active_key = None
                    # steps retained via a mid-segment checkpoint stay useful
                    retained = max(0, step - seg_start)
                    useful += retained
                    wasted += max(done - retained, 0)
                    session.add("recovery", self.ov.restore_hours(job.memory_gb))
                elif self.mode == "hybrid" and self.ckpt is not None:
                    self.ckpt.wait()
                    latest = self.ckpt.latest_step()
                    if latest is not None and latest > seg_start:
                        _, state = self.ckpt.restore(
                            latest, device=dev, like=seg_state
                        )
                        restore_total += tree_bytes(state)
                        step = latest
                        active_key = None
                        retained = max(0, step - seg_start)
                        useful += retained
                        wasted += max(done - retained, 0)
                        session.add("recovery", self.ov.restore_hours(job.memory_gb))
                    else:
                        # no checkpoint inside the segment: live-state
                        # handoff, same as siwoft (reshard on next pick)
                        state = _write_back(seg_state, snap)
                        step = seg_start
                        wasted += done
                        handoff = True
                else:
                    # P-SIWOFT: segment state survives via in-memory handoff
                    # (a live reshard onto the next market's mesh); steps
                    # inside the segment are lost
                    state = _write_back(seg_state, snap)
                    step = seg_start
                    wasted += done
                    handoff = True
                if handoff and alloc.is_split:
                    # one leg died, the rest of the mesh is alive: measure
                    # the lost leg's distinct-slice bytes NOW (the layout
                    # the survivors still hold) so the next pick can price
                    # a partial rebuild over DCN — same in siwoft & hybrid
                    leg_idx = alloc.markets.index(rev_market)
                    pending_repair = (alloc, rev_market)
                    pending_repair_bytes = leg_state_bytes(
                        seg_state, state_sh, plan, leg_idx
                    )
            if snap is not None:
                # a copy no handoff used (a hybrid restore) frees its memory
                snap.pop("leaves", None)
            # leg-level billing-cycle staggering: when a split lost ONE leg
            # and the live state survives (a repair is pending), only the
            # revoked leg's cycle closes here — the survivors' occupancy
            # continues into the repaired session, so their buffers defer
            # with their original anchors
            defer = pending_repair is not None and pending_repair[0] is alloc
            if defer or session.leg_anchors is not None:
                anchors = session.leg_anchors or (
                    (session.start_wall,) * len(alloc.markets)
                )
                releases = (
                    tuple(m == pending_repair[1] for m in alloc.markets)
                    if defer
                    else (True,) * len(alloc.markets)
                )
                session.leg_anchors = anchors
                session.leg_releases = releases
            if rec.enabled:
                rec.emit(obs_ev.session_billed(wall, session))
            wall += bill_session(session, price_of, bd)
            if defer:
                end = session.start_wall + session.used_hours
                for m, a, rel in zip(alloc.markets, anchors, releases):
                    if not rel:
                        carry_anchors[m] = (a, end)

        for m, (a, end) in sorted(carry_anchors.items()):
            if rec.enabled:
                rec.emit(
                    obs_ev.LegSettled(t=wall, market_id=int(m), anchor=a, end_wall=end)
                )
            settle_leg(bd, m, a, end, price_of)
        if self.ckpt is not None:
            self.ckpt.wait()
        # the breakdown carries the run's own revocation count and simulated
        # wall clock (report.wall_seconds stays the real perf-counter time),
        # which is also what makes the replay oracle uniform across loops
        bd.revocations = revs
        bd.wall_time = wall
        if rec.enabled:
            rec.emit(obs_ev.breakdown_pin(wall, bd))
            rec.emit(obs_ev.RunEnd(t=wall, wall_hours=wall))
        return OrchestratorReport(
            total_steps=useful + wasted,
            useful_steps=useful,
            wasted_steps=wasted,
            revocations=revs,
            markets_used=markets,
            cost_dollars=bd.total_cost,
            wall_seconds=time.perf_counter() - t0,  # repro-lint: disable=D001
            losses=losses,
            reshard_bytes=moved_total,
            restore_bytes=restore_total,
            reshard_events=reshard_events,
            mesh_shapes=mesh_shapes,
            breakdown=bd,
            shape_steps_per_hour={
                f"{k[1][0]}x{k[1][1]}": sps * SECONDS_PER_HOUR
                for k, sps in self.thr_tracker.measured.items()
            },
            cost_to_complete=first_ecc,
            allocations_used=allocations,
            leg_costs=dict(bd.leg_cost),
            leg_repairs=leg_repairs,
            snapshots=snapshots,
            decision_seconds=decision_seconds,
        )


def _snapshot(state: TrainState, step: int) -> Dict[str, Any]:
    """Copy every tensor of ``state`` to host memory (a clone where it
    already lives there); returns the copies with their bytes and seconds."""
    t0 = time.perf_counter()  # repro-lint: disable=D001
    leaves = tree_flatten(state)[0]
    host = [
        x.detach().to("cpu", copy=True) if isinstance(x, torch.Tensor) else x
        for x in leaves
    ]
    return {
        "step": step,
        "bytes": tree_bytes(state),
        "seconds": time.perf_counter() - t0,  # repro-lint: disable=D001
        "restore_seconds": None,
        "leaves": host,
    }


def _write_back(state: TrainState, snap: Optional[Dict[str, Any]]) -> TrainState:
    """``state`` with its tensors overwritten in place by ``snap``'s copies
    (no new device memory); without a snapshot, ``state`` as it is (no step
    ran, so it still holds the segment's start)."""
    if snap is None:
        return state
    t0 = time.perf_counter()  # repro-lint: disable=D001
    leaves, unflatten = tree_flatten(state)
    with torch.no_grad():
        out = [
            x.copy_(h) if isinstance(x, torch.Tensor) else h
            for x, h in zip(leaves, snap.pop("leaves"))
        ]
    if out and isinstance(out[0], torch.Tensor) and out[0].is_cuda:
        torch.cuda.synchronize(out[0].device)
    snap["restore_seconds"] = time.perf_counter() - t0  # repro-lint: disable=D001
    return unflatten(out)
