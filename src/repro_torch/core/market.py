"""Cloud spot markets: instance types, price traces, and the three market
features P-SIWOFT consumes (§III-A of the paper):

1. **lifetime / MTTR** — mean time until the spot price rises above the
   corresponding on-demand price (the paper's revocation proxy: customers
   won't bid above on-demand),
2. **revocation probability** of a provisioned instance
   = job_length / MTTR,
3. **revocation correlation** between markets — how often two markets
   revoked in the *same hourly billing cycle* over the past three months.

The paper collects real EC2 REST price traces; offline we generate
synthetic traces calibrated to the stylized facts the paper and its
citations report (spot ≈ 10–40 % of on-demand; *rare-revocation markets
exist* with MTTR > 600 h [Sharma et al., HotCloud'16]; revocations are
correlated within an availability zone and nearly independent across
zones/regions [Sharma et al. 2017]). A CSV loader accepts real traces.
Everything is seeded and deterministic.
"""
from __future__ import annotations

import csv
import dataclasses
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np

try:  # optional: 1.6× faster AR(1) (bit-exact; see _ar1_noise)
    from scipy.signal import lfilter as _lfilter
except ImportError:  # pragma: no cover - scipy ships in the repro image
    _lfilter = None

HOURS_3_MONTHS = 24 * 90  # one billing cycle per hour, 3-month feature window

# ---------------------------------------------------------------------------
# Per-shape throughput model
# ---------------------------------------------------------------------------
# A shape's delivered training speed, in units where the 1-device reference
# shape ≡ 1.0 work-hour per wall-hour. Scaling across devices is sublinear
# (collectives, stragglers): ``n`` devices deliver ``n^α`` speedup with
# α < 1, and the interconnect sets WHERE α lands between the floor and the
# ceiling — a faster fabric loses less of each step to collectives, so it
# scales closer to linear, but never reaches it. Because the bandwidth
# enters through the exponent, a 1-device shape (n^α = 1 for any α) is
# interconnect-invariant and exactly 1.0 — which is what keeps legacy
# single-device traces bit-identical to the pre-throughput simulator —
# and doubling devices multiplies throughput by 2^α < 2 at EVERY
# bandwidth, so the model cannot be gamed into superlinear scaling.
THROUGHPUT_EFFICIENCY_FLOOR = 0.6     # scaling exponent as bandwidth -> 0
THROUGHPUT_EFFICIENCY_CEIL = 0.95     # < 1: sublinear even on infinite fabric
REFERENCE_INTERCONNECT_GBPS = 10.0    # bandwidth at the floor/ceil midpoint


def shape_throughput(
    device_count: int,
    interconnect_gbps: float = REFERENCE_INTERCONNECT_GBPS,
    *,
    efficiency_floor: float = THROUGHPUT_EFFICIENCY_FLOOR,
    efficiency_ceil: float = THROUGHPUT_EFFICIENCY_CEIL,
) -> float:
    """Relative steps/hour of a mesh shape vs the 1-device reference.

    ``throughput(1, anything) == 1.0`` exactly; strictly increasing and
    sublinear in ``device_count`` (2× devices < 2× speed at any
    bandwidth); non-decreasing in ``interconnect_gbps`` for n > 1.
    The scaling exponent saturates from the floor toward the ceiling as
    ``bw / (bw + 10 GB/s)``: α(10) ≈ 0.78, α(25) = 0.85, α(60) = 0.9.
    """
    n = max(int(device_count), 1)
    if n == 1:
        return 1.0
    bw = max(float(interconnect_gbps), 0.0)
    alpha = efficiency_ceil - (efficiency_ceil - efficiency_floor) * (
        REFERENCE_INTERCONNECT_GBPS / (REFERENCE_INTERCONNECT_GBPS + bw)
    )
    return float(n) ** alpha


def resolved_throughput(
    steps_per_hour: Optional[float], device_count: int, interconnect_gbps: float
) -> float:
    """A shape's relative steps/hour: the measured ``steps_per_hour``
    override when present, else the analytic model — the single resolution
    rule shared by :class:`InstanceShape` and :class:`Market`."""
    if steps_per_hour is not None:
        return float(steps_per_hour)
    return shape_throughput(device_count, interconnect_gbps)


@dataclasses.dataclass(frozen=True)
class InstanceShape:
    """One instance-menu entry: a *mesh shape*, not just a price point.

    ``memory_gb`` is per accelerator device; a job fits when its sharded
    state fits ``memory_gb × device_count``. ``interconnect_gbps`` is the
    device-to-device bandwidth (GB/s) a live reshard moves bytes over —
    the denominator of the ``reshard`` time/cost component.
    ``steps_per_hour``, when set, overrides the analytic throughput model
    with a measured rate (relative to the 1-device reference shape).
    """

    instance_type: str
    memory_gb: int               # GiB per device
    on_demand_price: float       # $/h for the whole instance
    device_count: int = 1        # accelerators per instance
    interconnect_gbps: float = 10.0  # GB/s device interconnect
    steps_per_hour: Optional[float] = None  # measured relative throughput

    @property
    def total_memory_gb(self) -> float:
        return float(self.memory_gb * self.device_count)

    @property
    def throughput(self) -> float:
        """Relative steps/hour: measured override, else the analytic model."""
        return resolved_throughput(
            self.steps_per_hour, self.device_count, self.interconnect_gbps
        )


# EC2-ish accelerator menu. Deviation from the paper (which models CPU
# instances as memory sizes only): each entry is a mesh shape — device
# count and interconnect bandwidth — so heterogeneous-type provisioning
# (Voorsluys & Buyya; Qu et al.) has a real degree of freedom. Several
# entries share a total-memory class at different device counts so the
# suitable set spans *different mesh shapes* for the same job. Pricing is
# deliberately heterogeneous in $/throughput, the quantity the related
# heterogeneous-spot work shows varies wildly across types: the small
# accelerator box (g5.2xlarge) carries a per-device premium, while the big
# boxes get volume-style pricing that undercuts the 1-device reference per
# unit of WORK despite a much higher sticker $/h — price vs speed is a
# real trade, not a monotone ladder.
INSTANCE_MENU: Tuple[InstanceShape, ...] = (
    InstanceShape("m5.xlarge", 16, 0.192, device_count=1, interconnect_gbps=10.0),
    InstanceShape("m5.2xlarge", 32, 0.384, device_count=1, interconnect_gbps=10.0),
    InstanceShape("g5.2xlarge", 16, 0.402, device_count=2, interconnect_gbps=25.0),
    InstanceShape("g5.12xlarge", 16, 0.550, device_count=4, interconnect_gbps=25.0),
    InstanceShape("p3.16xlarge", 16, 1.100, device_count=8, interconnect_gbps=50.0),
    InstanceShape("p4d.24xlarge", 40, 1.200, device_count=8, interconnect_gbps=60.0),
)


def legacy_menu(menu: Sequence[InstanceShape] = INSTANCE_MENU) -> Tuple[InstanceShape, ...]:
    """The paper's memory-size-only menu: every shape collapsed to a single
    device holding its total memory. All throughputs are exactly 1.0, so
    provisioning trades price against MTTR only — the pre-throughput
    physics. Paper-exact reproductions (``benchmarks/fig1.py``, the C1–C3
    simulator tests) run on this; the heterogeneous default menu is the
    beyond-paper setting where price also trades against speed."""
    return tuple(
        dataclasses.replace(
            s,
            memory_gb=int(s.total_memory_gb),
            device_count=1,
            interconnect_gbps=REFERENCE_INTERCONNECT_GBPS,
            steps_per_hour=None,
        )
        for s in menu
    )

# 6 regions × 4 AZs = 24 markets per instance type. EC2 reality is ~75+;
# what matters for the paper's premise is that P(no rare-revocation market
# exists for a type) is negligible (0.75^24 ≈ 0.1 % here vs 3 % at 12).
REGIONS = (
    "us-east-1", "us-west-2", "eu-west-1",
    "ap-southeast-1", "ap-northeast-1", "eu-central-1",
)
ZONES_PER_REGION = 4


@dataclasses.dataclass(frozen=True)
class Market:
    """One (instance type × availability zone) spot market.

    Carries the menu entry's topology (``device_count``,
    ``interconnect_gbps``) so the provisioner can treat the market as a
    mesh shape and price a live reshard onto it.
    """

    market_id: int
    instance_type: str
    region: str
    zone: str
    memory_gb: int                   # GiB per device
    on_demand_price: float
    device_count: int = 1
    interconnect_gbps: float = 10.0
    steps_per_hour: Optional[float] = None  # measured relative throughput

    @property
    def total_memory_gb(self) -> float:
        return float(self.memory_gb * self.device_count)

    @property
    def throughput(self) -> float:
        """Relative steps/hour: measured override, else the analytic model."""
        return resolved_throughput(
            self.steps_per_hour, self.device_count, self.interconnect_gbps
        )


@dataclasses.dataclass
class MarketSet:
    """Markets + their hourly price traces (rows: market, cols: hour)."""

    markets: List[Market]
    prices: np.ndarray          # (n_markets, n_hours) $/h spot price
    start_hour: int = 0

    @property
    def n_hours(self) -> int:
        return self.prices.shape[1]

    def revocation_matrix(self) -> np.ndarray:
        """bool (n_markets, n_hours): hour h is a revocation hour for market m
        iff spot price > on-demand price (the paper's proxy)."""
        od = np.array([m.on_demand_price for m in self.markets])[:, None]
        return self.prices > od

    # ---- feature 1: lifetime / MTTR ------------------------------------
    def mttr_hours(self) -> np.ndarray:
        """Mean time between revocation events per market, in hours.

        Markets with zero revocations in the window get MTTR = n_hours × 2
        (">600 h" rare-revocation markets for a 3-month window)."""
        rev = self.revocation_matrix()
        counts = rev.sum(axis=1)
        with np.errstate(divide="ignore"):
            mttr = self.n_hours / np.maximum(counts, 1)
        mttr[counts == 0] = 2.0 * self.n_hours
        return mttr

    # ---- feature 3: revocation correlation -----------------------------
    def correlation_matrix(self) -> np.ndarray:
        """Jaccard co-revocation: |hours both revoked| / |hours either|.

        0 for pairs that never co-revoke (including never-revoking markets);
        1 on the diagonal for markets that ever revoke."""
        rev = self.revocation_matrix().astype(np.float64)
        inter = rev @ rev.T
        counts = rev.sum(axis=1)
        union = counts[:, None] + counts[None, :] - inter
        with np.errstate(divide="ignore", invalid="ignore"):
            corr = np.where(union > 0, inter / np.maximum(union, 1e-12), 0.0)
        return corr

    def spot_price(self, market_id: int, hour: int) -> float:
        h = min(int(hour), self.n_hours - 1)
        return float(self.prices[market_id, h])


def revocation_probability(job_length_hours: float, mttr_hours: float) -> float:
    """Paper §III-A / Alg.1 step 9: estimated revocation probability of a
    provisioned instance = job length / MTTR (clipped to [0, 1])."""
    if mttr_hours <= 0:
        return 1.0
    return float(min(1.0, job_length_hours / mttr_hours))


# ---------------------------------------------------------------------------
# Next-revocation index tables
# ---------------------------------------------------------------------------

def next_revocation_table(rev: np.ndarray) -> np.ndarray:
    """``table[m, h]`` = first hour ≥ h at which market m revokes, or -1.

    One vectorized suffix min-scan over the whole revocation matrix
    replaces the per-query ``np.argmax`` suffix slicing the simulators
    used to do on every provisioning decision: after this O(markets ×
    hours) build, each "when is this leg revoked next?" query is an O(1)
    table read. Semantics are pinned against the scalar reference
    (:func:`next_revocation_scalar`) by a hypothesis property test.
    """
    rev = np.asarray(rev, dtype=bool)
    _, n_hours = rev.shape
    # int32 indices (a year is 8760 hours) + in-place suffix scan: the
    # build is memory-bound, so halving the element size and skipping the
    # two intermediate allocations cuts it ~3× at 1000×8760 scale
    hours = np.arange(n_hours, dtype=np.int32)
    # n_hours acts as +inf; suffix-min from the right finds the next hit
    cand = np.where(rev, hours[None, :], np.int32(n_hours))
    np.minimum.accumulate(cand[:, ::-1], axis=1, out=cand[:, ::-1])
    cand[cand == n_hours] = -1
    return cand


def next_revocation_scalar(rev_row: np.ndarray, h0: int) -> Optional[int]:
    """Scalar oracle for :func:`next_revocation_table`: first True index of
    ``rev_row`` at or after ``h0`` in a single suffix pass (argmax, then an
    O(1) check of the element it landed on — not a separate ``.any()``
    scan), or None when the suffix is revocation-free or empty."""
    h0 = max(int(h0), 0)
    if h0 >= rev_row.shape[0]:
        return None
    tail = rev_row[h0:]
    idx = int(np.argmax(tail))
    return h0 + idx if tail[idx] else None


# ---------------------------------------------------------------------------
# Synthetic trace generator
# ---------------------------------------------------------------------------

def _build_markets(
    regions: Sequence[str],
    zones_per_region: int,
    menu: Sequence[InstanceShape],
) -> List[Market]:
    """The |regions| × zones × |menu| market list (no RNG involved)."""
    markets: List[Market] = []
    mid = 0
    for region in regions:
        for z in range(zones_per_region):
            zone = f"{region}{chr(ord('a') + z)}"
            for shape in menu:
                markets.append(
                    Market(
                        mid,
                        shape.instance_type,
                        region,
                        zone,
                        shape.memory_gb,
                        shape.on_demand_price,
                        device_count=shape.device_count,
                        interconnect_gbps=shape.interconnect_gbps,
                        steps_per_hour=shape.steps_per_hour,
                    )
                )
                mid += 1
    return markets


def _ar1_noise(eps: np.ndarray, phi: float) -> np.ndarray:
    """AR(1) recursion ``x[h] = phi * x[h-1] + eps[:, h]`` for ALL markets,
    bit-identical to :func:`_ar1_noise_scalar` (pinned by a hypothesis
    property test).

    Preferred path: ``scipy.signal.lfilter`` with ``b=[1], a=[1, -phi]``.
    Its direct-form-II-transposed update is ``y[n] = 1.0*x[n] + z;
    z = phi*y[n]`` — the same two IEEE-double ops as the recurrence with
    the addition commuted, and float addition is exactly commutative, so
    the output is bit-identical to the scalar loop (verified over random
    inputs before adoption, re-pinned by the property test). Fallback when
    scipy is absent: one Python pass over hours, each update elementwise
    across the market axis — also bit-identical, O(hours) interpreter
    steps instead of O(markets × hours)."""
    if _lfilter is not None:
        return _lfilter([1.0], [1.0, -phi], eps, axis=1)
    noise = np.empty_like(eps)
    x = np.zeros(eps.shape[0])
    for h in range(eps.shape[1]):  # single hour pass, vector across markets  # repro-lint: disable=V001
        x = phi * x + eps[:, h]
        noise[:, h] = x
    return noise


def _ar1_noise_scalar(eps: np.ndarray, phi: float) -> np.ndarray:
    """Scalar-oracle AR(1): the original per-market-per-hour loop."""
    noise = np.empty_like(eps)
    for i in range(eps.shape[0]):  # scalar oracle, kept for the bit-exactness tests  # repro-lint: disable=V001
        x = 0.0
        for h in range(eps.shape[1]):  # scalar oracle, kept for the bit-exactness tests  # repro-lint: disable=V001
            x = phi * x + eps[i, h]
            noise[i, h] = x
    return noise


def _draw_market_randomness(
    rng: np.random.Generator,
    markets: Sequence[Market],
    n_hours: int,
    rare_market_fraction: float,
):
    """Every per-market RNG draw of the trace generator, in the EXACT
    stream order the original scalar implementation consumed them
    (base_ratio → eps → rare → local_rate → local_spikes → zone-damp →
    spike_mult, market by market). Collecting the draws into (markets ×
    hours) arrays first is what lets the price composition be one
    vectorized expression without perturbing a single sample."""
    n = len(markets)
    # zone-shared spike trains (same-hour revocations within a zone)
    zones = sorted({m.zone for m in markets})
    zone_rate = {z: rng.uniform(0.0005, 0.004) for z in zones}
    zone_spikes = {
        z: rng.random(n_hours) < zone_rate[z] for z in zones
    }

    base_ratio = np.empty(n)
    eps = np.empty((n, n_hours))
    spikes = np.empty((n, n_hours), dtype=bool)
    spike_mult = np.empty((n, n_hours))
    for i, m in enumerate(markets):
        # EC2 spot discounts average 60–70 % off on-demand, but the paper's
        # F ≥ O cost ordering (Fig. 1d–f) implies its traces sat at the
        # shallow end; we default to U(0.55, 0.80) and ship a sensitivity
        # sweep over the ratio (benchmarks/fig1.py --ratio-sweep).
        base_ratio[i] = rng.uniform(0.55, 0.80)
        eps[i] = rng.normal(0.0, 0.015, n_hours)
        rare = rng.random() < rare_market_fraction
        local_rate = 0.0 if rare else rng.uniform(0.001, 0.02)
        local_spikes = rng.random(n_hours) < local_rate
        if rare:
            # rare markets ignore even most zone shocks (deeper capacity pool)
            spikes[i] = local_spikes | (
                zone_spikes[m.zone] & (rng.random(n_hours) < 0.1)
            )
        else:
            spikes[i] = local_spikes | zone_spikes[m.zone]
        spike_mult[i] = rng.uniform(1.05, 1.6, n_hours)
    return base_ratio, eps, spikes, spike_mult


def generate_markets(
    *,
    seed: int = 0,
    n_hours: int = HOURS_3_MONTHS,
    regions: Sequence[str] = REGIONS,
    zones_per_region: int = ZONES_PER_REGION,
    menu: Sequence[InstanceShape] = INSTANCE_MENU,
    rare_market_fraction: float = 0.25,
) -> MarketSet:
    """Markets = |regions| × zones × |menu|; hourly prices for ``n_hours``.

    Price process per market: base spot ratio ~ U(0.15, 0.40) of on-demand
    with AR(1) jitter, plus *spike* processes that push the price above
    on-demand (a revocation hour):

    * market-local spikes: Poisson with rate drawn per market; a
      ``rare_market_fraction`` of markets get rate ≈ 0 (the MTTR > 600 h
      markets the paper's key idea relies on),
    * zone-shared spikes: a per-zone shock hits every market in that zone
      (intra-zone revocation correlation; across zones independent).

    Vectorized over markets × hours, bit-identical to the retained scalar
    oracle :func:`generate_markets_scalar` (same ``default_rng`` draw
    order; see ``docs/simulator-perf.md`` for the contract).
    """
    rng = np.random.default_rng(seed)
    markets = _build_markets(regions, zones_per_region, menu)
    base_ratio, eps, spikes, spike_mult = _draw_market_randomness(
        rng, markets, n_hours, rare_market_fraction
    )
    # AR(1) mean-reverting jitter around the base ratio. The composition
    # runs in place on the (markets × hours) buffers we already own — at
    # 1000×8760 each avoided temporary is a 70 MB pass. Every rewrite is
    # value-exact: += / *= commute float + and × (exactly commutative),
    # clip(out=) and copyto(where=) select the same elements np.where
    # would.
    noise = _ar1_noise(eps, phi=0.97)
    noise += base_ratio[:, None]
    np.clip(noise, 0.05, 0.95, out=noise)              # ratio
    od = np.array([m.on_demand_price for m in markets])[:, None]
    noise *= od                                        # ratio * od
    spike_mult *= od                                   # od * spike_mult
    np.copyto(noise, spike_mult, where=spikes)         # spike hours win
    return MarketSet(markets=markets, prices=noise)


def generate_markets_scalar(
    *,
    seed: int = 0,
    n_hours: int = HOURS_3_MONTHS,
    regions: Sequence[str] = REGIONS,
    zones_per_region: int = ZONES_PER_REGION,
    menu: Sequence[InstanceShape] = INSTANCE_MENU,
    rare_market_fraction: float = 0.25,
) -> MarketSet:
    """Scalar-oracle trace generator: the original per-market-per-hour
    implementation of :func:`generate_markets`, kept verbatim as the
    reference the vectorized path must match bit-for-bit (asserted by
    ``benchmarks/sim_bench.py`` and ``tests/test_vectorized_core.py``)."""
    rng = np.random.default_rng(seed)
    markets = _build_markets(regions, zones_per_region, menu)
    n = len(markets)
    prices = np.empty((n, n_hours))

    zones = sorted({m.zone for m in markets})
    zone_rate = {z: rng.uniform(0.0005, 0.004) for z in zones}
    zone_spikes = {
        z: rng.random(n_hours) < zone_rate[z] for z in zones
    }

    for i, m in enumerate(markets):
        base_ratio = rng.uniform(0.55, 0.80)
        noise = np.empty(n_hours)
        x = 0.0
        phi, sig = 0.97, 0.015
        eps = rng.normal(0.0, sig, n_hours)
        for h in range(n_hours):  # scalar oracle, kept for the bit-exactness tests  # repro-lint: disable=V001
            x = phi * x + eps[h]
            noise[h] = x
        ratio = np.clip(base_ratio + noise, 0.05, 0.95)

        rare = rng.random() < rare_market_fraction
        local_rate = 0.0 if rare else rng.uniform(0.001, 0.02)
        local_spikes = rng.random(n_hours) < local_rate
        spikes = local_spikes | zone_spikes[m.zone]
        if rare:
            spikes = local_spikes | (zone_spikes[m.zone] & (rng.random(n_hours) < 0.1))

        price = ratio * m.on_demand_price
        spike_mult = rng.uniform(1.05, 1.6, n_hours)
        price = np.where(spikes, m.on_demand_price * spike_mult, price)
        prices[i] = price
    return MarketSet(markets=markets, prices=prices)


def split_history_future(ms: MarketSet, history_hours: int) -> Tuple[MarketSet, MarketSet]:
    """Features are computed on the past window; jobs run on the future one."""
    hist = MarketSet(ms.markets, ms.prices[:, :history_hours], start_hour=0)
    fut = MarketSet(
        ms.markets, ms.prices[:, history_hours:], start_hour=history_hours
    )
    return hist, fut


def load_csv_traces(path: str) -> MarketSet:
    """Real-trace loader: CSV columns = market_id,instance_type,region,zone,
    memory_gb,on_demand_price[,device_count,interconnect_gbps]
    [,steps_per_hour],h0,h1,... (one row per market; full schema in
    ``docs/trace-format.md``). The topology and throughput columns are
    optional — legacy traces without them load as single-device instances
    with unit throughput. Detection is header-driven: a headerless file is
    always parsed as the legacy 6-meta-column format, so traces that carry
    any optional column MUST include the header row. An empty
    ``steps_per_hour`` cell means "no measurement" (analytic model used)."""
    markets: List[Market] = []
    rows: List[List[float]] = []
    n_meta = 6
    col: Dict[str, int] = {}
    with open(path) as f:
        for rec in csv.reader(f):
            if rec[0] == "market_id":
                if "h0" in rec:
                    n_meta = rec.index("h0")
                elif any(
                    c in rec
                    for c in ("device_count", "interconnect_gbps", "steps_per_hour")
                ):
                    # price columns unlabeled: the header names exactly the
                    # metadata block, so its length IS the block width (the
                    # PR 2 topology traces shipped this way)
                    n_meta = len(rec)
                col = {name: i for i, name in enumerate(rec[:n_meta])}
                continue
            kw = {}
            if "device_count" in col:
                kw["device_count"] = int(rec[col["device_count"]])
            if "interconnect_gbps" in col:
                kw["interconnect_gbps"] = float(rec[col["interconnect_gbps"]])
            if "steps_per_hour" in col and rec[col["steps_per_hour"]].strip():
                kw["steps_per_hour"] = float(rec[col["steps_per_hour"]])
            markets.append(
                Market(
                    market_id=int(rec[0]),
                    instance_type=rec[1],
                    region=rec[2],
                    zone=rec[3],
                    memory_gb=int(rec[4]),
                    on_demand_price=float(rec[5]),
                    **kw,
                )
            )
            rows.append([float(x) for x in rec[n_meta:]])
    return MarketSet(markets=markets, prices=np.asarray(rows))
