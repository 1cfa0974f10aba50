"""P-SIWOFT — Algorithm 1, implemented faithfully step by step.

Function names mirror the paper's pseudocode:

    Step 2   FindSuitableServers(J, R)      -> find_suitable_servers
    Step 3   ComputeLifeTime(M, U)          -> compute_lifetime
    Step 5   ServerBasedLifeTime(j, M, L)   -> server_based_lifetime
    Step 7   Highest(S_j)                   -> highest
    Step 8   length(s_j) >> length(j)       -> lifetime_admits (MTTR ≥ 2L)
    Step 9   RevocationProbability(j, s_j)  -> market.revocation_probability
    Step 13  FindLowCorrelation(j, s_j)     -> find_low_correlation
    Step 14  S_j ← (S_j \\ {s_j}) ∩ W_{s_j} -> restrict_after_revocation

The paper leaves two situations unspecified; our choices (documented in
DESIGN.md §Deviations):

* no market passes the MTTR ≥ 2L filter → we keep the MTTR-descending order
  over all suitable markets (best effort) instead of failing the job;
* the correlation filter empties S_j → we refill with the remaining
  suitable markets (minus already-revoked ones), again MTTR-descending.

Instance-menu deviation (beyond the paper): the paper matches a job to the
single smallest memory size that fits; our markets are *mesh shapes*
(``device_count`` accelerators × ``memory_gb`` each, see
``repro.core.market.InstanceShape``), so :func:`find_suitable_servers`
matches the job's sharded state footprint against the instance's TOTAL
memory (``memory_gb × device_count``) and keeps every shape within a
bounded overshoot (default 4×) of the tightest fit. The suitable set
therefore spans heterogeneous mesh shapes (Voorsluys & Buyya; Qu et al.)
and Algorithm 1's MTTR ordering chooses among them; a revocation can
re-provision onto a *different* shape, which the orchestrator handles as
a live cross-mesh reshard.

Allocation deviation (beyond the paper, ISSUE 4): the unit Algorithm 1
ranks and provisions is a multi-leg :class:`repro.core.allocation.
Allocation`, not a bare market index. When some single shape fits the job
the candidate set is exactly the paper's (single-leg allocations, same
order — bit-identical to the pre-allocation provisioner); when NONE fits,
:func:`find_suitable_allocations` searches splits of the job across up to
``policy.max_legs`` low-correlation markets, priced with the combined
DCN-discounted throughput and the min-over-legs MTTR (admission is
strictly harder for wider splits). After a revocation of one leg,
:func:`find_low_correlation` / :func:`restrict_after_revocation` filter
against the revoked market AND every surviving leg, keeping one-leg
repairs eligible.

Throughput deviation (beyond the paper): every shape carries a relative
throughput (``market.shape_throughput`` — sublinear in device count,
mildly increasing in interconnect, ``1.0`` for the 1-device reference),
so a job's wall time is shape-dependent. Ranking within an MTTR tier is
by *expected cost-to-complete* — historical price integrated over the
shape's wall time, inflated by the restart-expectation ``1/(1 - wall/MTTR)``
— instead of raw $/h (:func:`expected_cost_to_complete`). The MTTR
admission filter compares the market's lifetime against the job's wall
time ON THAT SHAPE. Heterogeneous-spot cost-efficiency requires
normalizing price by delivered throughput (Qu et al., arXiv:1509.05197;
Voorsluys & Buyya, arXiv:1110.5969); with a single-device menu every
throughput is 1.0 and all of this degenerates to the paper's exact
price-vs-MTTR behavior.
"""
from __future__ import annotations

import dataclasses
from typing import Dict, List, Optional, Sequence, Set, Tuple, Union

import numpy as np

from repro_torch.core.allocation import Allocation, combined_throughput
from repro_torch.core.market import MarketSet
from repro_torch.core.policies import Job, SiwoftPolicy, work_to_wall_hours

# Algorithm-1 candidates are Allocations since the multi-leg refactor; the
# int form survives for the per-market primitives the FT baselines and the
# feature layer still speak.
Candidate = Union[int, Allocation]


@dataclasses.dataclass
class MarketFeatures:
    """The three §III-A features, computed ONCE from the history window,
    plus the per-shape throughput (beyond the paper) that turns raw $/h
    into $/unit-of-work."""

    mttr: np.ndarray          # (n_markets,) hours
    corr: np.ndarray          # (n_markets, n_markets) co-revocation in [0,1]
    memory_gb: np.ndarray     # (n_markets,) GiB per device
    on_demand: np.ndarray     # (n_markets,)
    avg_price: np.ndarray     # (n_markets,) mean historical spot price
    device_count: np.ndarray = None      # (n_markets,) devices per instance
    interconnect_gbps: np.ndarray = None  # (n_markets,) GB/s reshard bandwidth
    throughput: np.ndarray = None         # (n_markets,) rel. steps/hour (1-dev ≡ 1)

    def __post_init__(self):
        if self.device_count is None:
            self.device_count = np.ones_like(self.memory_gb)
        if self.interconnect_gbps is None:
            self.interconnect_gbps = np.full_like(self.memory_gb, 10.0)
        if self.throughput is None:
            self.throughput = np.ones_like(self.memory_gb)

    @property
    def total_memory_gb(self) -> np.ndarray:
        """The instance shape's aggregate memory: what the job's *sharded*
        state footprint must fit into."""
        return self.memory_gb * self.device_count

    @classmethod
    def from_history(cls, history: MarketSet) -> "MarketFeatures":
        # One pass over the market objects instead of five comprehensions.
        # m.throughput stays a per-market scalar call on purpose: it routes
        # through libm's pow (float ** alpha), and swapping it for np.power
        # could drift the last ulp of the ranking keys.
        n = len(history.markets)
        memory_gb = np.empty(n)
        on_demand = np.empty(n)
        device_count = np.empty(n)
        interconnect_gbps = np.empty(n)
        throughput = np.empty(n)
        for i, m in enumerate(history.markets):
            memory_gb[i] = m.memory_gb
            on_demand[i] = m.on_demand_price
            device_count[i] = m.device_count
            interconnect_gbps[i] = m.interconnect_gbps
            throughput[i] = m.throughput
        return cls(
            mttr=history.mttr_hours(),
            corr=history.correlation_matrix(),
            memory_gb=memory_gb,
            on_demand=on_demand,
            avg_price=history.prices.mean(axis=1),
            device_count=device_count,
            interconnect_gbps=interconnect_gbps,
            throughput=throughput,
        )


# --- throughput-aware cost-to-complete (beyond the paper) -------------------

# Expected-cost revocation-risk cap: a market whose estimated revocation
# probability reaches 1 would have infinite expected cost; clip so the
# fallback ordering over hopeless markets stays finite and price-sensitive.
MAX_REVOCATION_RISK = 0.95


def wall_hours(work_hours: float, feats: MarketFeatures, market: int) -> float:
    """Wall-clock hours market ``market`` needs for ``work_hours`` of work
    (work is measured in hours on the 1-device reference shape)."""
    return work_to_wall_hours(work_hours, float(feats.throughput[market]))


def cost_to_complete(work_hours: float, feats: MarketFeatures, market: int) -> float:
    """$ to run ``work_hours`` of reference work on ``market``, ignoring
    revocations: historical price integrated over the shape-dependent wall
    time — i.e. price/throughput, not raw price."""
    return float(feats.avg_price[market]) * wall_hours(work_hours, feats, market)


def expected_cost_to_complete(
    work_hours: float, feats: MarketFeatures, market: int
) -> float:
    """Revocation-risk-adjusted cost-to-complete.

    A restart-from-scratch policy that gets revoked must repurchase the
    whole run; with per-attempt revocation probability v (the paper's
    ``wall / MTTR`` estimate) the expected number of purchases is ~1/(1-v),
    so the expected bill inflates by that factor. Longer wall occupancy —
    i.e. slower shapes — inflates more, which is exactly how a pricier
    8-device shape can undercut a cheap 1-device shape on a long job."""
    wall = wall_hours(work_hours, feats, market)
    v = min(wall / max(float(feats.mttr[market]), 1e-9), MAX_REVOCATION_RISK)
    return cost_to_complete(work_hours, feats, market) / (1.0 - v)


def expected_cost_to_complete_batch(
    work_hours: float, feats: MarketFeatures, markets: Sequence[int]
) -> np.ndarray:
    """:func:`expected_cost_to_complete` over a whole candidate set at once.

    Elementwise mirror of the scalar chain (same IEEE-double ops in the
    same order: divide by clamped throughput, price × wall, clip risk,
    inflate), so every entry equals the scalar value BIT-FOR-BIT and sort
    keys built from either are interchangeable — the property tests pin
    this. Turns candidate scoring from O(set size) Python calls into one
    fused numpy expression.
    """
    idx = np.asarray(markets, dtype=np.intp)
    w = float(work_hours)
    wall = w / np.maximum(feats.throughput[idx], 1e-9)
    ctc = feats.avg_price[idx] * wall
    v = np.minimum(wall / np.maximum(feats.mttr[idx], 1e-9), MAX_REVOCATION_RISK)
    return ctc / (1.0 - v)


# --- allocation-level composition (multi-leg meshes over DCN) ---------------
#
# Single-leg allocations DELEGATE to the per-market functions above, so a
# one-market allocation prices, admits, and ranks bit-identically to the
# bare market index it replaced (the PR 3 legacy-equivalence guarantee).

def allocation_throughput(alloc: Allocation, feats: MarketFeatures) -> float:
    """Relative steps/hour of an allocation. One leg: the market's own
    (possibly measured/calibrated) throughput. Multi-leg: the analytic
    sublinear law over the union device count at the DCN-capped effective
    bandwidth — never better than the same devices on one interconnect."""
    if len(alloc) == 1:
        return float(feats.throughput[alloc.legs[0].market])
    return combined_throughput(
        alloc.device_counts,
        [float(feats.interconnect_gbps[m]) for m in alloc.markets],
        alloc.dcn_gbps,
    )


def allocation_mttr(alloc: Allocation, feats: MarketFeatures) -> float:
    """Any leg revocation interrupts the job: MTTR composes as the MIN over
    legs — the honest survival model, which makes the Alg. 1 admission rule
    strictly harder for wider splits."""
    return min(float(feats.mttr[m]) for m in alloc.markets)


def allocation_price(alloc: Allocation, feats: MarketFeatures) -> float:
    """Hourly price of the whole allocation: legs bill independently."""
    return float(sum(float(feats.avg_price[m]) for m in alloc.markets))


def allocation_memory_gb(alloc: Allocation, feats: MarketFeatures) -> float:
    """Aggregate memory across legs — what the job's sharded state (now
    spread over the union mesh) must fit into."""
    return float(sum(float(feats.total_memory_gb[m]) for m in alloc.markets))


def allocation_wall_hours(
    work_hours: float, feats: MarketFeatures, alloc: Allocation
) -> float:
    if len(alloc) == 1:
        return wall_hours(work_hours, feats, alloc.legs[0].market)
    return work_to_wall_hours(work_hours, allocation_throughput(alloc, feats))


def allocation_cost_to_complete(
    work_hours: float, feats: MarketFeatures, alloc: Allocation
) -> float:
    if len(alloc) == 1:
        return cost_to_complete(work_hours, feats, alloc.legs[0].market)
    return allocation_price(alloc, feats) * allocation_wall_hours(
        work_hours, feats, alloc
    )


def allocation_expected_cost_to_complete(
    work_hours: float, feats: MarketFeatures, alloc: Allocation
) -> float:
    """Risk-adjusted cost-to-complete of an allocation: same restart
    expectation as the per-market rule, with wall time at the combined
    throughput and revocation risk against the min-over-legs MTTR."""
    if len(alloc) == 1:
        return expected_cost_to_complete(work_hours, feats, alloc.legs[0].market)
    wall = allocation_wall_hours(work_hours, feats, alloc)
    v = min(wall / max(allocation_mttr(alloc, feats), 1e-9), MAX_REVOCATION_RISK)
    return allocation_cost_to_complete(work_hours, feats, alloc) / (1.0 - v)


# --- Alg. 1 steps -----------------------------------------------------------

def find_suitable_servers(
    job: Job, feats: MarketFeatures, *, max_overshoot: float = 4.0
) -> List[int]:
    """Step 2, menu-aware: a market is suitable when the job's sharded state
    footprint fits the instance shape's TOTAL memory
    (``memory_gb × device_count``) and the shape is not wastefully large
    (total ≤ ``max_overshoot`` × the tightest fitting total). The returned
    candidates are ordered by expected cost-to-complete ascending (price
    integrated over the shape-dependent wall time, risk-adjusted) — NOT by
    raw $/h: a pricier shape that finishes the work faster ranks ahead of
    a cheap slow one.

    Deviation from the paper (which keeps only the single smallest memory
    size): the bounded-overshoot band deliberately keeps *several mesh
    shapes* in play so Algorithm 1 provisions across heterogeneous instance
    types — the degree of freedom the related heterogeneous-spot work
    exploits — while still excluding shapes that only waste money."""
    total = feats.total_memory_gb
    fits_mask = total >= job.memory_gb
    if not fits_mask.any():
        return []
    best = total[fits_mask].min()
    suitable = np.flatnonzero(fits_mask & (total <= max_overshoot * best))
    # one vectorized scoring pass over the whole suitable set, then an
    # argsort on (score, index) — same keys, same order as the per-market
    # sorted(..., key=expected_cost_to_complete) it replaces
    ecc = expected_cost_to_complete_batch(job.length_hours, feats, suitable)
    order = np.lexsort((suitable, ecc))
    return [int(i) for i in suitable[order]]


def find_suitable_allocations(
    job: Job,
    feats: MarketFeatures,
    policy: Optional[SiwoftPolicy] = None,
    *,
    max_overshoot: float = 4.0,
    max_legs: Optional[int] = None,
    split_margin: Optional[float] = None,
    exclude: Set[int] = frozenset(),
) -> List[Allocation]:
    """Step 2, allocation-first: the candidate set Algorithm 1 ranks.

    Single-leg allocations wrap :func:`find_suitable_servers` one-for-one
    (same markets, same expected-cost order), so when any single shape fits
    and splits are not opportunistically enabled the candidate set is the
    paper's — bit-identical ordering to the pre-allocation provisioner.

    The SPLIT-SEARCH path activates when
    * no single shape fits the job (the case the paper cannot provision
      without fault tolerance), or
    * ``split_margin`` is set (policy knob ``SiwoftPolicy.split_margin``)
      and some split's expected cost-to-complete beats the best single
      shape by at least that fraction.

    Splits are pairs-to-``max_legs``-tuples of distinct markets whose
    combined memory fits the job, gated by a PAIRWISE correlation budget
    when a policy is given (``SiwoftPolicy.split_corr_cut``): every pair
    of legs must co-revoke below the budget — a split correlated with
    itself revokes as one market but pays DCN prices, strictly dominated.
    The gate is enforced incrementally (each new leg against every chosen
    leg), so a 3-leg candidate under ``max_legs=3`` is admitted only when
    all three pairs qualify; its MTTR still composes as min over legs, so
    wider splits face a strictly harder admission test. Ranking is by
    allocation expected cost-to-complete; the honest min-MTTR survival
    model and the DCN-discounted throughput are both priced in, so the
    search only surfaces splits that genuinely earn their coupling cost.
    """
    if policy is not None:
        max_legs = policy.max_legs if max_legs is None else max_legs
        split_margin = (
            policy.split_margin if split_margin is None else split_margin
        )
    max_legs = 2 if max_legs is None else max(int(max_legs), 1)

    singles = [
        Allocation.single(i, int(feats.device_count[i]))
        for i in find_suitable_servers(job, feats, max_overshoot=max_overshoot)
        if i not in exclude
    ]
    if singles and split_margin is None:
        return singles
    if max_legs < 2:
        return singles

    corr_cut = policy.split_corr_cut if policy is not None else 1.0
    totals = feats.total_memory_gb
    n = len(totals)
    pool = [i for i in range(n) if i not in exclude]
    # widest shapes first: a split wants the fewest, biggest legs
    pool.sort(key=lambda i: (-float(totals[i]), i))

    splits: List[Allocation] = []

    def grow(legs: List[int], mem: float, start: int) -> None:
        if len(legs) >= 2 and mem >= job.memory_gb:
            splits.append(
                Allocation.of(legs, [int(feats.device_count[m]) for m in legs])
            )
            return  # a fitting split never benefits from MORE legs (min-MTTR)
        if len(legs) >= max_legs:
            return
        for k in range(start, len(pool)):
            j = pool[k]
            if any(float(feats.corr[j, m]) >= corr_cut for m in legs):
                continue
            grow(legs + [j], mem + float(totals[j]), k + 1)

    grow([], 0.0, 0)
    if not splits and corr_cut < 1.0:
        # correlation filter emptied the split set: refill without it (same
        # fallback discipline as Alg. 1's step-13 refill)
        corr_cut = 1.0
        grow([], 0.0, 0)

    splits.sort(
        key=lambda a: (
            allocation_expected_cost_to_complete(job.length_hours, feats, a),
            a.markets,
        )
    )
    if not singles:
        return splits
    best_single = allocation_expected_cost_to_complete(
        job.length_hours, feats, singles[0]
    )
    margin = float(split_margin or 0.0)
    good_splits = [
        a
        for a in splits
        if allocation_expected_cost_to_complete(job.length_hours, feats, a)
        < best_single * (1.0 - margin)
    ]
    merged = singles + good_splits
    merged.sort(
        key=lambda a: (
            allocation_expected_cost_to_complete(job.length_hours, feats, a),
            a.markets,
        )
    )
    return merged


def compute_lifetime(feats: MarketFeatures, suitable: Sequence[int]) -> Dict[int, float]:
    """Step 3: lifetime (MTTR) per suitable market."""
    return {i: float(feats.mttr[i]) for i in suitable}


def compute_allocation_lifetimes(
    feats: MarketFeatures, suitable: Sequence[Allocation]
) -> Dict[Allocation, float]:
    """Step 3 over allocations: lifetime = min over legs (any leg revocation
    interrupts the job)."""
    return {a: allocation_mttr(a, feats) for a in suitable}


def server_based_lifetime(
    job: Job,
    lifetimes: Dict[Candidate, float],
    policy: SiwoftPolicy,
    feats: Optional[MarketFeatures] = None,
) -> List[Candidate]:
    """Step 5: keep markets whose lifetime admits the job (MTTR ≥ 2 × the
    job's *wall time on that shape*), sorted by lifetime descending. Ties
    (e.g. several never-revoking markets, or markets sharing a revocation
    count) break toward the lowest expected cost-to-complete — price
    integrated over the shape-dependent wall time, risk-adjusted — instead
    of raw $/h, so among equally-safe markets Algorithm 1 deliberately
    provisions the shape that finishes the work cheapest, which may be a
    pricier-per-hour but faster mesh. The paper does not specify
    tie-breaking; see module docstring. Falls back to all candidates
    (same ordering) when the filter is empty."""
    admitted = [
        i for i, lt in lifetimes.items()
        if lt >= policy.lifetime_factor * _wall(job, feats, i)
    ]
    pool = admitted if admitted else list(lifetimes)
    return sorted(
        pool, key=lambda i: (-lifetimes[i], _ecc(job, feats, i), _stable(i))
    )


def _stable(c: Candidate):
    """Deterministic final sort key: the market index, or the allocation's
    market tuple (for single-leg allocations that orders exactly like the
    bare index did)."""
    return c.markets if isinstance(c, Allocation) else c


def _markets(c: Candidate) -> Tuple[int, ...]:
    return c.markets if isinstance(c, Allocation) else (c,)


def _wall(job: Job, feats: Optional[MarketFeatures], c: Candidate) -> float:
    """Job wall time on candidate ``c`` (== length when features are absent)."""
    if feats is None:
        return job.length_hours
    if isinstance(c, Allocation):
        return allocation_wall_hours(job.length_hours, feats, c)
    return wall_hours(job.length_hours, feats, c)


def _ecc(job: Job, feats: Optional[MarketFeatures], c: Candidate) -> float:
    """Tie-break key: expected cost-to-complete (0 when features absent)."""
    if feats is None:
        return 0.0
    if isinstance(c, Allocation):
        return allocation_expected_cost_to_complete(job.length_hours, feats, c)
    return expected_cost_to_complete(job.length_hours, feats, c)


def highest(S: Sequence[Candidate]) -> Candidate:
    """Step 7: S is kept lifetime-descending; the head is the highest."""
    return S[0]


def lifetime_admits(
    job: Job, lifetime: float, policy: SiwoftPolicy, throughput: float = 1.0
) -> bool:
    """Step 8 guard, throughput-aware: the market must outlive the job's
    wall occupancy on ITS shape, not the reference-length — a fast shape
    shrinks its own exposure window."""
    return lifetime >= policy.lifetime_factor * job.wall_hours_on(throughput)


def find_low_correlation(
    feats: MarketFeatures,
    revoked_market: int,
    policy: SiwoftPolicy,
    surviving: Sequence[int] = (),
) -> Set[int]:
    """Step 13, allocation-aware: markets whose co-revocation with the
    revoked market — AND with every surviving leg of the interrupted
    allocation — over the 3-month history is below the threshold. A
    replacement leg correlated with a leg the job still holds would turn
    the next zone shock into a double revocation, which is exactly what the
    filter exists to prevent; with no surviving legs (the single-market
    case) this is the paper's step 13 unchanged."""
    corr = feats.corr[revoked_market]
    out = {i for i in range(corr.shape[0]) if corr[i] < policy.correlation_threshold}
    for s in surviving:
        out &= {
            i
            for i in range(corr.shape[0])
            if feats.corr[s, i] < policy.correlation_threshold
        }
    return out


def restrict_after_revocation(
    S: List[Candidate],
    revoked: Candidate,
    W: Set[int],
    lifetimes: Dict[Candidate, float],
    already_revoked: Set[int],
    feats: Optional[MarketFeatures] = None,
    job: Optional[Job] = None,
    surviving: Sequence[int] = (),
) -> List[Candidate]:
    """Step 14 (+ fallback): S ← (S \\ {s}) ∩ W, lifetime-descending with
    the expected-cost-to-complete tie-break (pass ``job`` + ``feats`` to
    enable it; ``job`` carries the remaining work the cost is integrated
    over).

    Allocation-aware: a candidate survives the restriction only when EVERY
    leg market is in W or among the interrupted allocation's surviving legs
    (a repair that keeps live legs must stay eligible even though a leg is
    trivially correlated with itself). The revoked market itself is never
    in W (self-correlation is 1), so any candidate touching it drops out.
    For single-leg candidates this reduces to the pre-allocation rule
    ``i != revoked and i in W`` exactly."""
    keep = W | set(surviving)
    rest = [
        c for c in S if c != revoked and all(m in keep for m in _markets(c))
    ]
    if not rest:
        rest = [
            c
            for c in lifetimes
            if c != revoked
            and not any(m in already_revoked for m in _markets(c))
        ]
    if job is not None:
        tiebreak = lambda c: _ecc(job, feats, c)
    elif feats is not None:
        tiebreak = lambda c: (
            allocation_price(c, feats)
            if isinstance(c, Allocation)
            else float(feats.avg_price[c])
        )
    else:
        tiebreak = lambda c: 0.0
    return sorted(rest, key=lambda c: (-lifetimes[c], tiebreak(c), _stable(c)))


def remaining_job(job: Job, remaining_work_hours: float) -> Job:
    """The job with only its unfinished work — what re-provisioning after a
    revocation should integrate price/throughput over."""
    return dataclasses.replace(
        job, length_hours=max(float(remaining_work_hours), 1e-9)
    )


def plan_first_choice(
    job: Job, feats: MarketFeatures, policy: SiwoftPolicy
) -> Allocation:
    """Convenience: the allocation Alg. 1 provisions first for this job —
    a single-leg allocation whenever one shape fits (the paper's case), a
    multi-leg split when none does (or when ``policy.split_margin`` lets a
    sufficiently cheaper split win)."""
    suitable = find_suitable_allocations(job, feats, policy)
    if not suitable:
        raise ValueError(
            f"no allocation (≤{policy.max_legs} legs) fits {job.memory_gb} GB"
        )
    lifetimes = compute_allocation_lifetimes(feats, suitable)
    return highest(server_based_lifetime(job, lifetimes, policy, feats))
