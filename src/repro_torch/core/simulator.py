"""Discrete-event simulator for jobs on spot markets (paper §IV–§V).

Methodology mirrors the paper exactly:

* fault-tolerance baselines receive a FIXED, seeded number of revocations
  placed uniformly over the job's compute progress ("we randomly send a
  fixed number of revocations per day of the job's execution length"),
* P-SIWOFT's revocations are TRACE-DRIVEN: the provisioned market revokes
  at the first future hour whose spot price exceeds on-demand (the same
  proxy its MTTR feature is built on) — markets chosen by Algorithm 1
  rarely hit one,
* costs accrue per hourly billing cycle at the hour's spot price, and the
  unused tail of each started cycle is charged to ``billing_buffer``,
* time/cost decompose into the paper's stacked components (execution,
  re-execution, checkpointing, recovery, startup, buffer).

Progress-based classification: ``max_progress`` tracks the furthest point
ever computed; any compute below it re-done after a revocation counts as
``re_execution``, first-time compute counts as ``execution`` (so execution
always totals the job length, and overhead is visible separately).
"""
from __future__ import annotations

import math
from typing import List, Optional, Sequence, Set, Tuple

import numpy as np

from repro_torch.core import provisioner as alg
from repro_torch.core.accounting import Breakdown, PriceTable, Session, bill_session
from repro_torch.obs import events as obs_ev
from repro_torch.obs.recorder import current as obs_current
from repro_torch.core.allocation import Allocation
from repro_torch.core.market import MarketSet, next_revocation_scalar, next_revocation_table
from repro_torch.core.policies import (
    CheckpointPolicy,
    Job,
    MigrationPolicy,
    OnDemandPolicy,
    OverheadModel,
    ReplicationPolicy,
    SiwoftPolicy,
)

MAX_ATTEMPTS = 1000  # hard stop for pathological market sets


class Simulator:
    def __init__(
        self,
        history: MarketSet,
        future: MarketSet,
        overheads: OverheadModel = OverheadModel(),
        seed: int = 0,
        engine: str = "vectorized",
        feats: Optional[alg.MarketFeatures] = None,
    ):
        """``engine="vectorized"`` (default) routes billing through a
        :class:`PriceTable`, answers next-revocation queries from a
        precomputed suffix-scan table, and memoizes suitable sets per job
        footprint. ``engine="reference"`` keeps the original scalar code
        paths end-to-end — the oracle ``benchmarks/sim_bench.py`` asserts
        bit-exact breakdown equality against. ``feats`` optionally injects
        precomputed :class:`MarketFeatures` (so benchmark harnesses can
        share the O(markets²) correlation matrix across engines)."""
        assert engine in ("vectorized", "reference"), engine
        self.history = history
        self.future = future
        self.ov = overheads
        self.seed = seed
        self.engine = engine
        self.feats = (
            alg.MarketFeatures.from_history(history) if feats is None else feats
        )
        self._rev_matrix = future.revocation_matrix()
        self._next_rev_table: Optional[np.ndarray] = None
        # suitable-set memos: the FT baselines recompute the identical
        # candidate list on every one of up to MAX_ATTEMPTS attempts; the
        # returned lists are never mutated by callers, so sharing is safe
        self._servers_cache: dict = {}
        self._allocs_cache: dict = {}
        if engine == "vectorized":
            self._price = PriceTable(future.prices)
        else:
            prices, n_last = future.prices, future.n_hours - 1
            self._price = lambda market_id, hour: float(
                prices[market_id, min(int(hour), n_last)]
            )

    # ------------------------------------------------------------------
    # helpers
    # ------------------------------------------------------------------
    def _const_price(self, price: float):
        """Flat $/h price source (on-demand): a PriceTable on the vectorized
        engine so ``bill_session`` takes its batched path, the equivalent
        legacy closure on the reference engine."""
        if self.engine == "vectorized":
            return PriceTable.constant(price)
        return lambda m, h: price

    def _suitable_servers(self, job: Job) -> List[int]:
        if self.engine == "reference":
            return alg.find_suitable_servers(job, self.feats)
        key = (job.memory_gb, job.length_hours)
        out = self._servers_cache.get(key)
        if out is None:
            out = alg.find_suitable_servers(job, self.feats)
            self._servers_cache[key] = out
        return out

    def _suitable_allocations(self, job: Job, policy: SiwoftPolicy):
        if self.engine == "reference":
            return alg.find_suitable_allocations(job, self.feats, policy)
        # frozen-dataclass policies hash by value, so the key is stable
        key = (job.memory_gb, job.length_hours, policy)
        out = self._allocs_cache.get(key)
        if out is None:
            out = alg.find_suitable_allocations(job, self.feats, policy)
            self._allocs_cache[key] = out
        return out

    def _throughput(self, market_id: int) -> float:
        """Relative work rate of the market's shape (1-device ≡ 1.0)."""
        return max(float(self.feats.throughput[market_id]), 1e-9)

    def _od_choice(self, job: Job) -> Tuple[float, float]:
        """On-demand reference, throughput-aware: (price $/h, throughput) of
        the fitting shape with the lowest cost-to-complete — od price
        integrated over the shape's wall time, not the lowest raw $/h. On a
        single-device menu this degenerates to the cheapest fitting
        instance (the paper's reference)."""
        fit = [m for m in self.future.markets if m.total_memory_gb >= job.memory_gb]
        best = min(fit, key=lambda m: m.on_demand_price / m.throughput)
        return best.on_demand_price, best.throughput

    def _select_ft_market(
        self,
        job: Job,
        wall: float,
        exclude: Set[int],
        mode: str,
        salt: int,
        within: Optional[Set[int]] = None,
    ) -> int:
        """FT-baseline market choice: "random" (paper: no market
        intelligence) or "cheapest" (price-aware variant). ``within``
        restricts candidates to one instance-shape class (replication:
        replicas must be interchangeable)."""
        hour = min(int(wall), self.future.n_hours - 1)
        suitable = self._suitable_servers(job)
        if within is not None:
            suitable = [i for i in suitable if i in within] or suitable
        cands = [i for i in suitable if i not in exclude]
        if not cands:
            cands = suitable
        if mode == "cheapest":
            return min(cands, key=lambda i: self.future.prices[i, hour])
        rng = np.random.default_rng(
            np.random.SeedSequence(entropy=self.seed, spawn_key=(job.job_id, salt, len(exclude)))
        )
        return int(cands[rng.integers(len(cands))])

    def _next_trace_revocation(self, market_id: int, wall: float) -> Optional[float]:
        """First revocation hour ≥ wall in the future window (None if none).

        Vectorized engine: O(1) lookup in the lazily-built suffix-scan
        table. Reference engine: the scalar single-pass suffix scan (which
        also fixes the historical double scan — argmax THEN a separate
        ``.any()`` over the same suffix)."""
        h0 = int(math.ceil(wall))
        if self.engine == "reference":
            idx = next_revocation_scalar(self._rev_matrix[market_id], h0)
            return None if idx is None else float(idx)
        if self._next_rev_table is None:
            self._next_rev_table = next_revocation_table(self._rev_matrix)
        if h0 < 0:
            h0 = 0
        if h0 >= self._next_rev_table.shape[1]:
            return None
        idx = int(self._next_rev_table[market_id, h0])
        return None if idx < 0 else float(idx)

    def _next_allocation_revocation(
        self, alloc: Allocation, wall: float
    ) -> Tuple[Optional[float], Optional[int]]:
        """Earliest trace revocation across the allocation's legs: (hour,
        revoked leg's market). Any leg revocation interrupts the job —
        the min-composition the allocation MTTR prices a priori. Leg order
        breaks exact ties (deterministic)."""
        best: Tuple[Optional[float], Optional[int]] = (None, None)
        for m in alloc.markets:
            t = self._next_trace_revocation(m, wall)
            if t is not None and (best[0] is None or t < best[0]):
                best = (t, m)
        return best

    def _ft_revocation_points(self, job: Job, n: int, salt: int) -> List[float]:
        rng = np.random.default_rng(
            np.random.SeedSequence(entropy=self.seed, spawn_key=(job.job_id, salt))
        )
        return sorted(rng.uniform(0.0, job.length_hours, size=n).tolist())

    # ------------------------------------------------------------------
    # policies
    # ------------------------------------------------------------------
    def run_job(
        self,
        job: Job,
        policy,
        n_revocations: int = 0,
        start_wall: float = 0.0,
    ) -> Breakdown:
        from repro_torch.core.portfolio import PortfolioPolicy

        # Both engines run the SAME policy code below and bill bit-identical
        # breakdowns, so with a recorder active they emit IDENTICAL event
        # logs — a cross-engine pin tests/test_obs.py holds with ==.
        rec = obs_current()
        if rec.enabled:
            rec.emit(
                obs_ev.RunStart(
                    t=start_wall,
                    subsystem="simulator",
                    label=type(policy).__name__,
                    horizon_hours=float(self.future.n_hours),
                )
            )
            rec.emit(obs_ev.price_trace(start_wall, self.future.prices))
        if isinstance(policy, PortfolioPolicy):
            bd = self._run_portfolio(job, policy, start_wall)
        elif isinstance(policy, SiwoftPolicy):
            bd = self._run_siwoft(job, policy, start_wall)
        elif isinstance(policy, CheckpointPolicy):
            bd = self._run_checkpoint(job, policy, n_revocations, start_wall)
        elif isinstance(policy, MigrationPolicy):
            bd = self._run_migration(job, policy, n_revocations, start_wall)
        elif isinstance(policy, ReplicationPolicy):
            bd = self._run_replication(job, policy, n_revocations, start_wall)
        elif isinstance(policy, OnDemandPolicy):
            bd = self._run_on_demand(job, start_wall)
        else:
            raise TypeError(policy)
        if bd.wall_time == 0.0:
            bd.wall_time = bd.total_time
        if rec.enabled:
            rec.emit(obs_ev.breakdown_pin(bd.wall_time, bd))
            rec.emit(obs_ev.RunEnd(t=bd.wall_time, wall_hours=bd.wall_time))
        return bd

    def run_jobs(self, jobs: Sequence[Job], policy, n_revocations: int = 0) -> Breakdown:
        """Alg. 1 steps 4–20: totals over the job set (step 19/21)."""
        total = Breakdown()
        for job in jobs:
            total.add(self.run_job(job, policy, n_revocations=n_revocations))
        return total

    # --- P-SIWOFT ------------------------------------------------------
    def _run_siwoft(self, job: Job, policy: SiwoftPolicy, start_wall: float) -> Breakdown:
        """Progress is tracked in WORK hours (reference-shape compute); the
        provisioned allocation converts work ↔ wall at its (combined)
        throughput θ, so a faster shape bills fewer wall hours for the same
        job. Candidates are allocations: single-leg whenever one menu shape
        fits (the paper's case, bit-identical to the pre-allocation
        simulator), multi-leg splits over DCN when none does. A revocation
        of ONE leg interrupts the whole attempt (min-MTTR semantics); the
        restriction step then excludes markets correlated with the revoked
        leg or with any surviving leg."""
        rec = obs_current()
        bd = Breakdown()
        suitable = self._suitable_allocations(job, policy)  # step 2
        if not suitable:
            raise ValueError(
                f"job {job.job_id}: {job.memory_gb} GB fits no allocation of "
                f"≤{policy.max_legs} legs — widen max_legs or the menu"
            )
        lifetimes = alg.compute_allocation_lifetimes(self.feats, suitable)  # step 3
        S = alg.server_based_lifetime(job, lifetimes, policy, self.feats)  # step 5
        wall = start_wall
        max_progress = 0.0
        last_ckpt = 0.0  # only advances in the beyond-paper hybrid mode
        revoked: Set[int] = set()

        for _ in range(MAX_ATTEMPTS):                                  # step 6
            a = alg.highest(S)                                         # step 7
            thr = max(alg.allocation_throughput(a, self.feats), 1e-9)
            # step 9's revocation-probability estimate (wall / MTTR) is
            # folded into the expected-cost-to-complete ranking that
            # ordered S — see alg.expected_cost_to_complete
            session = Session(a.legs[0].market, wall, legs=a.markets)
            session.add("startup", self.ov.startup_hours)              # provision (step 10)
            if rec.enabled:
                rec.emit(
                    obs_ev.Provision(
                        t=wall,
                        market_id=int(a.legs[0].market),
                        legs=tuple(int(m) for m in a.markets),
                    )
                )
            resume_from = last_ckpt if policy.uses_checkpoints else 0.0
            if policy.uses_checkpoints and resume_from > 0:
                session.add("recovery", self.ov.restore_hours(job.memory_gb))

            t_rev, rev_market = self._next_allocation_revocation(a, wall)  # step 11 driver
            compute_start = wall + session.used_hours
            progress = resume_from

            def run_until(target_progress: float, available_wall: float) -> Tuple[float, float]:
                """Advance ≤ available wall hours toward the target work
                progress at rate θ; returns (new progress, wall hours
                spent) split into exec/re-exec components."""
                nonlocal max_progress
                span = min(target_progress - progress, available_wall * thr)
                if span <= 0:
                    return progress, 0.0
                redo = max(0.0, min(max_progress, progress + span) - progress)
                fresh = span - redo
                if redo > 0:
                    session.add("re_execution", redo / thr)
                if fresh > 0:
                    session.add("execution", fresh / thr)
                max_progress = max(max_progress, progress + span)
                return progress + span, span / thr

            if policy.uses_checkpoints:
                # hybrid (beyond paper): periodic checkpoints while running
                horizon = math.inf if t_rev is None else t_rev - compute_start
                t_used = 0.0
                while progress < job.length_hours and t_used < horizon:
                    next_stop = min(last_ckpt + policy.ckpt_interval_hours, job.length_hours)
                    progress, spent = run_until(next_stop, horizon - t_used)
                    t_used += spent
                    if progress >= next_stop and progress < job.length_hours:
                        ck = self.ov.ckpt_hours(job.memory_gb)
                        if t_used + ck > horizon:
                            break
                        session.add("checkpointing", ck)
                        t_used += ck
                        last_ckpt = progress
                    if progress >= job.length_hours:
                        break
            else:
                horizon = math.inf if t_rev is None else t_rev - compute_start
                progress, _ = run_until(job.length_hours, horizon)

            if rec.enabled:
                rec.emit(obs_ev.session_billed(wall, session))
            wall_used = bill_session(session, self._price, bd)
            wall += wall_used
            if progress >= job.length_hours:                            # step 18
                return bd
            # revocation (steps 11–15): lose everything since last_ckpt.
            # Only ONE leg's market revoked; the whole attempt is
            # interrupted, but surviving legs stay eligible for repairs.
            bd.revocations += 1
            if rec.enabled:
                rec.emit(obs_ev.Revoke(t=wall, market_id=int(rev_market)))
            revoked.add(rev_market)
            surviving_legs = tuple(m for m in a.markets if m != rev_market)
            W = alg.find_low_correlation(
                self.feats, rev_market, policy, surviving=surviving_legs
            )                                                          # step 13
            # re-rank for the REMAINING work: the cost-to-complete tie-break
            # integrates price/throughput over what is left — for hybrid,
            # everything past the newest checkpoint (last_ckpt may have
            # advanced during this attempt); for pure siwoft, the whole job
            surviving = last_ckpt if policy.uses_checkpoints else 0.0
            rem = alg.remaining_job(job, job.length_hours - surviving)
            S = alg.restrict_after_revocation(
                S, a, W, lifetimes, revoked, self.feats, job=rem,
                surviving=surviving_legs,
            )                                                          # step 14
            wall = max(wall, 0.0 if t_rev is None else t_rev)
        raise RuntimeError("siwoft: exceeded MAX_ATTEMPTS")

    # --- beyond-paper: portfolio failover chain ---------------------------
    def _run_portfolio(self, job: Job, policy, start_wall: float) -> Breakdown:
        """Same no-FT execution as P-SIWOFT; provisioning order is the
        proactively diversified portfolio chain (core/portfolio.py)."""
        from repro_torch.core.portfolio import portfolio_failover_order

        rec = obs_current()
        bd = Breakdown()
        order = portfolio_failover_order(job, self.feats, policy)
        wall = start_wall
        max_progress = 0.0
        for s_m in order:
            thr = self._throughput(s_m)
            session = Session(s_m, wall)
            session.add("startup", self.ov.startup_hours)
            if rec.enabled:
                rec.emit(
                    obs_ev.Provision(t=wall, market_id=int(s_m), legs=(int(s_m),))
                )
            t_rev = self._next_trace_revocation(s_m, wall)
            compute_start = wall + session.used_hours
            horizon = math.inf if t_rev is None else t_rev - compute_start
            # work done before the revocation horizon, at the shape's rate
            span = min(job.length_hours, max(horizon, 0.0) * thr)
            redo = min(max_progress, span)
            if redo > 0:
                session.add("re_execution", redo / thr)
            if span - redo > 0:
                session.add("execution", (span - redo) / thr)
            max_progress = max(max_progress, span)
            if rec.enabled:
                rec.emit(obs_ev.session_billed(wall, session))
            wall += bill_session(session, self._price, bd)
            if span >= job.length_hours:
                return bd
            bd.revocations += 1
            if rec.enabled:
                rec.emit(obs_ev.Revoke(t=wall, market_id=int(s_m)))
            wall = max(wall, 0.0 if t_rev is None else t_rev)
        raise RuntimeError("portfolio: exhausted every market")

    # --- FT baseline: checkpointing -------------------------------------
    def _run_checkpoint(
        self, job: Job, policy: CheckpointPolicy, n_rev: int, start_wall: float
    ) -> Breakdown:
        rec = obs_current()
        bd = Breakdown()
        rev_points = self._ft_revocation_points(job, n_rev, salt=1)
        wall = start_wall
        progress = 0.0
        max_progress = 0.0
        last_ckpt = 0.0
        revoked: Set[int] = set()
        rev_iter = iter(rev_points + [math.inf])
        next_rev = next(rev_iter)
        first = True

        for _ in range(MAX_ATTEMPTS):
            m = self._select_ft_market(job, wall, revoked, policy.market_selection, salt=11)
            thr = self._throughput(m)
            session = Session(m, wall)
            session.add("startup", self.ov.startup_hours)
            if rec.enabled:
                rec.emit(obs_ev.Provision(t=wall, market_id=int(m), legs=(int(m),)))
            if not first:
                session.add("recovery", self.ov.restore_hours(job.memory_gb))
            first = False

            # run until either completion or the next injected revocation
            # (progress / revocation points are WORK coordinates; the
            # session bills wall hours at the provisioned shape's rate)
            while progress < job.length_hours and progress < next_rev:
                stop = min(
                    last_ckpt + policy.ckpt_interval_hours,
                    job.length_hours,
                    next_rev,
                )
                span = stop - progress
                redo = max(0.0, min(max_progress, stop) - progress)
                fresh = span - redo
                if redo > 0:
                    session.add("re_execution", redo / thr)
                if fresh > 0:
                    session.add("execution", fresh / thr)
                max_progress = max(max_progress, stop)
                progress = stop
                if (
                    progress >= last_ckpt + policy.ckpt_interval_hours
                    and progress < job.length_hours
                    and progress < next_rev
                ):
                    session.add("checkpointing", self.ov.ckpt_hours(job.memory_gb))
                    last_ckpt = progress

            if rec.enabled:
                rec.emit(obs_ev.session_billed(wall, session))
            wall += bill_session(session, self._price, bd)
            if progress >= job.length_hours:
                return bd
            # revocation: roll back to the last checkpoint
            bd.revocations += 1
            if rec.enabled:
                rec.emit(obs_ev.Revoke(t=wall, market_id=int(m)))
            revoked.add(m)
            progress = last_ckpt
            next_rev = next(rev_iter)
        raise RuntimeError("checkpoint: exceeded MAX_ATTEMPTS")

    # --- FT baseline: migration ----------------------------------------
    def _run_migration(
        self, job: Job, policy: MigrationPolicy, n_rev: int, start_wall: float
    ) -> Breakdown:
        rec = obs_current()
        bd = Breakdown()
        rev_points = self._ft_revocation_points(job, n_rev, salt=2)
        wall = start_wall
        progress = 0.0
        max_progress = 0.0
        revoked: Set[int] = set()
        rev_iter = iter(rev_points + [math.inf])
        next_rev = next(rev_iter)
        mig_ok = (
            job.memory_gb <= self.ov.live_migration_max_gb
            and self.ov.migration_hours(job.memory_gb) <= self.ov.revocation_notice_hours
        )

        for _ in range(MAX_ATTEMPTS):
            m = self._select_ft_market(job, wall, revoked, policy.market_selection, salt=12)
            thr = self._throughput(m)
            session = Session(m, wall)
            session.add("startup", self.ov.startup_hours)
            if rec.enabled:
                rec.emit(obs_ev.Provision(t=wall, market_id=int(m), legs=(int(m),)))
            span = min(job.length_hours, next_rev) - progress
            redo = max(0.0, min(max_progress, progress + span) - progress)
            if redo > 0:
                session.add("re_execution", redo / thr)
            if span - redo > 0:
                session.add("execution", (span - redo) / thr)
            max_progress = max(max_progress, progress + span)
            progress += span
            if progress >= job.length_hours:
                if rec.enabled:
                    rec.emit(obs_ev.session_billed(wall, session))
                wall += bill_session(session, self._price, bd)
                return bd
            # revocation with 2-minute notice
            bd.revocations += 1
            if rec.enabled:
                rec.emit(obs_ev.Revoke(t=wall, market_id=int(m)))
            revoked.add(m)
            if mig_ok:
                session.add("recovery", self.ov.migration_hours(job.memory_gb))
                # state moves: no lost work
            else:
                progress = 0.0  # unplanned kill: no FT state to resume from
            if rec.enabled:
                rec.emit(obs_ev.session_billed(wall, session))
            wall += bill_session(session, self._price, bd)
            next_rev = next(rev_iter)
        raise RuntimeError("migration: exceeded MAX_ATTEMPTS")

    # --- FT baseline: replication ---------------------------------------
    def _run_replication(
        self, job: Job, policy: ReplicationPolicy, n_rev: int, start_wall: float
    ) -> Breakdown:
        """Degree-k task duplication: k replicas run the whole job; the n_rev
        injected revocations each kill one replica (round-robin), which
        restarts FROM SCRATCH on a fresh market (no state is carried — that
        is the point of replication). The job completes when the first
        replica finishes; every other replica-hour is ``re_execution``
        overhead, which is how replication pays for its fault tolerance.

        Replicas must be interchangeable (any survivor IS the job), so all
        of them are placed within the tightest-fitting instance-shape
        class at that class's fastest throughput — the heterogeneous menu
        is a siwoft/portfolio degree of freedom, not a replication one."""
        rec = obs_current()
        bd = Breakdown()
        totals = self.feats.total_memory_gb
        best_total = totals[totals >= job.memory_gb].min()
        cls = [i for i in range(len(totals)) if totals[i] == best_total]
        # same-total markets can still be different mesh shapes (e.g. 1×32 GB
        # vs 2×16 GB): pin replicas to the fastest shape in the class so
        # every replica runs at one rate and any survivor IS the job
        thr = max(self._throughput(i) for i in cls)
        shape_class = {i for i in cls if self._throughput(i) == thr}
        wall_len = job.wall_hours_on(thr)
        k = policy.degree
        # kill times: wall offsets, uniform over the replica's wall length
        kills = [t / thr for t in self._ft_revocation_points(job, n_rev, salt=3)]
        # replica r is killed at kills[i] for i ≡ r (mod k)
        last_kill = [0.0] * k
        kill_lists: List[List[float]] = [[] for _ in range(k)]
        for i, t in enumerate(kills):
            kill_lists[i % k].append(t)
            last_kill[i % k] = max(last_kill[i % k], t)
        finish = [lk + wall_len for lk in last_kill]
        winner = int(np.argmin(finish))
        t_star = finish[winner]

        excl: Set[int] = set()
        for r in range(k):
            # sessions: [start, kill_1), [kill_1, kill_2), ..., [last, t*)
            boundaries = [0.0] + kill_lists[r] + [t_star]
            for s_i in range(len(boundaries) - 1):
                t0, t1 = boundaries[s_i], boundaries[s_i + 1]
                if t1 <= t0:
                    continue
                m = self._select_ft_market(
                    job, start_wall + t0, excl, policy.market_selection,
                    salt=13, within=shape_class,
                )
                excl.add(m)
                session = Session(m, start_wall + t0)
                session.add("startup", self.ov.startup_hours)
                if rec.enabled:
                    rec.emit(
                        obs_ev.Provision(
                            t=start_wall + t0,
                            market_id=int(m),
                            legs=(int(m),),
                            replica_id=r,
                        )
                    )
                run = min(t1 - t0, wall_len)
                is_winning_run = r == winner and s_i == len(boundaries) - 2
                session.add("execution" if is_winning_run else "re_execution", run)
                if s_i < len(boundaries) - 2:
                    bd.revocations += 1
                    if rec.enabled:
                        rec.emit(
                            obs_ev.Revoke(
                                t=start_wall + t1, market_id=int(m), replica_id=r
                            )
                        )
                if rec.enabled:
                    rec.emit(obs_ev.session_billed(start_wall + t0, session))
                bill_session(session, self._price, bd)
        bd.wall_time = t_star + self.ov.startup_hours
        return bd

    # --- on-demand reference ---------------------------------------------
    def _run_on_demand(self, job: Job, start_wall: float) -> Breakdown:
        rec = obs_current()
        bd = Breakdown()
        price, thr = self._od_choice(job)
        session = Session(-1, start_wall)
        session.add("startup", self.ov.startup_hours)
        session.add("execution", job.wall_hours_on(thr))
        if rec.enabled:
            rec.emit(obs_ev.Provision(t=start_wall, market_id=-1, legs=(-1,)))
            # the constant on-demand price replays via PriceTable.constant —
            # identical on both engines, whatever _const_price returned
            rec.emit(obs_ev.session_billed(start_wall, session, price_const=float(price)))
        bill_session(session, self._const_price(price), bd)
        return bd
