"""The port's copies of ``repro.core.simulator`` and ``repro.core.portfolio``
against the reference, on the CPU: every policy's ``Breakdown`` ``==`` and
the same event stream on seeds 0 and 1; the ``exact`` block of
``BENCH_sim.json`` (scalar and vectorized paths bit-exact) in the port's
copy; and the paper's C1–C3 orderings and the portfolio's properties
(``tests/test_simulator.py``, ``tests/test_portfolio.py``) on the port's
modules."""
import dataclasses
import json
from pathlib import Path

import numpy as np
import pytest

import repro.core as ref_core
import repro_torch.core as core
from repro.obs import events as ref_events
from repro.obs.recorder import recording as ref_recording
from repro_torch.core import provisioner as alg
from repro_torch.core.accounting import Breakdown, PriceTable, Session, bill_session
from repro_torch.core.market import generate_markets_scalar
from repro_torch.core.portfolio import (
    PortfolioPolicy,
    max_chain_correlation,
    portfolio_failover_order,
    select_portfolio,
)
from repro_torch.obs import events
from repro_torch.obs.recorder import recording

REPO = Path(__file__).resolve().parents[1]

# (policy name, constructor kwargs, n_revocations): every policy the
# simulator runs, the hybrid (siwoft with checkpoints) included
POLICIES = [
    ("SiwoftPolicy", {}, 0),
    ("SiwoftPolicy", {"name": "hybrid", "ckpt_interval_hours": 2.0}, 0),
    ("CheckpointPolicy", {}, 4),
    ("MigrationPolicy", {}, 3),
    ("ReplicationPolicy", {"degree": 2}, 2),
    ("OnDemandPolicy", {}, 0),
    ("PortfolioPolicy", {}, 0),
]
JOBS = [(24.0, 16.0), (60.0, 30.0), (140.0, 64.0)]


def _policy(pkg, name, kw):
    return getattr(pkg, name)(**kw)


def _breakdown_fields(bd):
    return (dataclasses.asdict(bd), bd.total_cost, bd.total_time)


def _sim(pkg, seed):
    ms = pkg.generate_markets(seed=seed, n_hours=24 * 90 + 24 * 45)
    hist, fut = pkg.split_history_future(ms, 24 * 90)
    return pkg.Simulator(hist, fut, seed=seed)


@pytest.mark.parametrize("seed", [0, 1])
@pytest.mark.parametrize("name,kw,nrev", POLICIES, ids=[
    f"{n}-{k.get('name', '')}" for n, k, _ in POLICIES])
def test_simulator_matches_reference(seed, name, kw, nrev):
    ref_sim, sim = _sim(ref_core, seed), _sim(core, seed)
    for hours, gb in JOBS:
        with ref_recording() as ref_rec:
            ref_bd = ref_sim.run_job(ref_core.Job(hours, gb), _policy(ref_core, name, kw),
                                     n_revocations=nrev)
        with recording() as rec:
            bd = sim.run_job(core.Job(hours, gb), _policy(core, name, kw), n_revocations=nrev)
        assert _breakdown_fields(bd) == _breakdown_fields(ref_bd), (hours, gb)
        got = [events.as_dict(e) for e in rec.events]
        assert got == [ref_events.as_dict(e) for e in ref_rec.events], (hours, gb)
        assert got


@pytest.mark.parametrize("module", ["core/simulator.py", "core/portfolio.py",
                                    "obs/recorder.py"])
def test_copy_equals_reference_apart_from_imports(module):
    """The JAX-free copies are the reference's files with ``repro``
    renamed to ``repro_torch`` (the recorder's ``count``, ``observe``,
    ``clear`` and ``set_current`` included), nothing else."""
    port = (REPO / "src" / "repro_torch" / module).read_text()
    ref = (REPO / "src" / "repro" / module).read_text()
    assert port.replace("repro_torch", "repro") == ref


def test_recorder_counters_histograms_and_set_current():
    from repro_torch.obs import recorder

    rec = recorder.Recorder()
    rec.count("a")
    rec.count("a", 2)
    rec.observe("h", 1.5)
    assert rec.counters == {"a": 3} and rec.histograms == {"h": [1.5]}
    recorder.set_current(rec)
    try:
        assert recorder.current() is rec
    finally:
        recorder.set_current(None)
    assert not recorder.current().enabled
    rec.clear()
    assert rec.counters == {} and rec.histograms == {} and rec.events == []


# ---------------------------------------------------------------------------
# BENCH_sim.json's exact block, in the port's copy (benchmarks/sim_bench.py's
# stages at its quick size: the default 144-market menu, 1464 hours)
# ---------------------------------------------------------------------------

SIM_SEED, SIM_HOURS, SIM_QUERIES = 0, 1464, 20_000


@pytest.fixture(scope="module")
def bench_markets():
    return core.generate_markets(seed=SIM_SEED, n_hours=SIM_HOURS)


def _exact_trace(ms):
    return np.array_equal(generate_markets_scalar(seed=SIM_SEED, n_hours=SIM_HOURS).prices,
                          ms.prices)


def _exact_next_revocation(ms):
    rev = ms.revocation_matrix()
    n, n_hours = rev.shape
    q_m = [(7 * i) % n for i in range(SIM_QUERIES)]
    q_h = [(13 * i) % (n_hours + 2) for i in range(SIM_QUERIES)]
    got_s = [core.next_revocation_scalar(rev[m], h) for m, h in zip(q_m, q_h)]
    table = core.next_revocation_table(rev)
    qm, qh = np.asarray(q_m), np.asarray(q_h)
    ans = np.where(qh >= n_hours, -1, table[qm, np.minimum(qh, n_hours - 1)])
    return got_s == [None if a < 0 else int(a) for a in ans]


def _exact_billing(ms):
    _, fut = core.split_history_future(ms, ms.n_hours // 2)
    prices, n_last = fut.prices, fut.n_hours - 1
    sessions = lambda: [Session(m.market_id, 0.25, intervals=[("execution", fut.n_hours - 0.5)])
                        for m in fut.markets]
    bd_s, bd_v = Breakdown(), Breakdown()
    for s in sessions():
        bill_session(s, lambda m, h: float(prices[m, min(int(h), n_last)]), bd_s)
    for s in sessions():
        bill_session(s, PriceTable(fut.prices), bd_v)
    return (bd_s.time, bd_s.cost, bd_s.leg_cost, bd_s.sessions) == (
        bd_v.time, bd_v.cost, bd_v.leg_cost, bd_v.sessions)


def _exact_simulate(ms):
    hist, fut = core.split_history_future(ms, ms.n_hours // 2)
    feats = alg.MarketFeatures.from_history(hist)
    lengths, mems = (60.0, 140.0, 260.0, 380.0), (16.0, 30.0, 64.0, 120.0)
    jobs = [core.Job(length_hours=lengths[i % 4], memory_gb=mems[i % 4], job_id=i)
            for i in range(8)]

    def run(engine):
        sim = core.Simulator(hist, fut, seed=0, engine=engine, feats=feats)
        out = Breakdown()
        out.add(sim.run_jobs(jobs, core.SiwoftPolicy()))
        out.add(sim.run_jobs(jobs, core.CheckpointPolicy(), n_revocations=2))
        return out

    s, v = run("reference"), run("vectorized")
    return (s.time, s.cost, s.leg_cost, s.revocations, s.sessions) == (
        v.time, v.cost, v.leg_cost, v.revocations, v.sessions)


@pytest.mark.parametrize("key,check", [
    ("trace_bitexact", _exact_trace),
    ("next_revocation_equal", _exact_next_revocation),
    ("billing_bitexact", _exact_billing),
    ("simulate_bitexact", _exact_simulate),
])
def test_bench_sim_exact_block_holds_in_the_port(bench_markets, key, check):
    exact = json.loads((REPO / "BENCH_sim.json").read_text())["exact"]
    assert exact[key] is True
    assert check(bench_markets) is True


# ---------------------------------------------------------------------------
# the paper's claims C1-C3 (tests/test_simulator.py) on the port's modules
# ---------------------------------------------------------------------------

N_SEEDS = 5
JOB = core.Job(length_hours=24, memory_gb=16)


@pytest.fixture(scope="module")
def sims():
    out = []
    for seed in range(N_SEEDS):
        ms = core.generate_markets(seed=seed, n_hours=24 * 90 + 24 * 45,
                                   menu=core.legacy_menu())
        hist, fut = core.split_history_future(ms, 24 * 90)
        out.append(core.Simulator(hist, fut, seed=seed))
    return out


def _avg(sims, job, policy, nrev):
    bds = [s.run_job(job, policy, n_revocations=nrev) for s in sims]
    return float(np.mean([b.wall_time for b in bds])), float(np.mean([b.total_cost for b in bds]))


def test_c1_completion_time_ordering(sims):
    t_p, _ = _avg(sims, JOB, core.SiwoftPolicy(), 0)
    t_o, _ = _avg(sims, JOB, core.OnDemandPolicy(), 0)
    t_f, _ = _avg(sims, JOB, core.CheckpointPolicy(), 4)
    assert t_p < t_f
    assert abs(t_p - t_o) / t_o < 0.10


def test_c2_cost_ordering(sims):
    _, c_p = _avg(sims, JOB, core.SiwoftPolicy(), 0)
    _, c_o = _avg(sims, JOB, core.OnDemandPolicy(), 0)
    for nrev in (2, 4, 8, 16):
        _, c_f = _avg(sims, JOB, core.CheckpointPolicy(), nrev)
        assert c_p < c_f, f"nrev={nrev}"
    assert c_p < c_o
    _, c_f16 = _avg(sims, JOB, core.CheckpointPolicy(), 16)
    assert c_f16 >= c_o


def test_c3_ft_overheads_grow_with_memory(sims):
    ck_small = ck_big = p_small = p_big = 0.0
    for s in sims:
        b1 = s.run_job(core.Job(24, 8), core.CheckpointPolicy(), n_revocations=4)
        b2 = s.run_job(core.Job(24, 64), core.CheckpointPolicy(), n_revocations=4)
        ck_small += b1.time["checkpointing"] + b1.time["recovery"]
        ck_big += b2.time["checkpointing"] + b2.time["recovery"]
        p1 = s.run_job(core.Job(24, 8), core.SiwoftPolicy())
        p2 = s.run_job(core.Job(24, 64), core.SiwoftPolicy())
        p_small += p1.total_time - p1.time["execution"]
        p_big += p2.total_time - p2.time["execution"]
    assert ck_big > 2 * ck_small
    assert abs(p_big - p_small) < 0.5 * N_SEEDS


def test_c3_ft_overheads_grow_with_revocations(sims):
    b2 = [s.run_job(JOB, core.CheckpointPolicy(), n_revocations=2) for s in sims]
    b16 = [s.run_job(JOB, core.CheckpointPolicy(), n_revocations=16) for s in sims]
    assert sum(b.wall_time for b in b16) > sum(b.wall_time for b in b2)
    assert sum(b.total_cost for b in b16) > sum(b.total_cost for b in b2)


@pytest.mark.parametrize("name,kw,nrev", [
    ("SiwoftPolicy", {}, 0), ("CheckpointPolicy", {}, 4), ("OnDemandPolicy", {}, 0),
    ("MigrationPolicy", {}, 3)])
def test_execution_time_equals_job_length(sims, name, kw, nrev):
    for s in sims:
        bd = s.run_job(JOB, _policy(core, name, kw), n_revocations=nrev)
        assert bd.time["execution"] == pytest.approx(JOB.length_hours, rel=1e-6)


def test_siwoft_has_no_ft_components_and_costs_sum(sims):
    for s in sims:
        bd = s.run_job(JOB, core.SiwoftPolicy())
        assert bd.time["checkpointing"] == 0.0 and bd.time["recovery"] == 0.0
    bd = sims[0].run_job(JOB, core.CheckpointPolicy(), n_revocations=4)
    assert bd.total_cost == pytest.approx(sum(bd.cost.values()))
    assert bd.cost["billing_buffer"] > 0


# ---------------------------------------------------------------------------
# the portfolio's properties (tests/test_portfolio.py) on the port's modules
# ---------------------------------------------------------------------------

@pytest.fixture(scope="module")
def volatile_sims():
    out = []
    for seed in range(8):
        ms = core.generate_markets(seed=100 + seed, n_hours=24 * 150, rare_market_fraction=0.0)
        hist, fut = core.split_history_future(ms, 24 * 90)
        out.append(core.Simulator(hist, fut, seed=seed))
    return out


def test_portfolio_chain_size_admissible_and_covering(volatile_sims):
    sim = volatile_sims[0]
    job = core.Job(24, 16)
    chain = select_portfolio(job, sim.feats, PortfolioPolicy(size=4))
    suitable = alg.find_suitable_servers(job, sim.feats)
    assert len(chain) == 4 and len(set(chain)) == 4 and set(chain) <= set(suitable)
    order = portfolio_failover_order(job, sim.feats, PortfolioPolicy())
    assert sorted(order) == sorted(suitable)


def test_portfolio_chain_diversity_no_worse_than_naive(volatile_sims):
    job = core.Job(48, 16)
    for sim in volatile_sims:
        feats = sim.feats
        lifetimes = alg.compute_lifetime(feats, alg.find_suitable_servers(job, feats))
        naive = alg.server_based_lifetime(job, lifetimes, core.SiwoftPolicy(), feats)[:4]
        chain = select_portfolio(job, feats, PortfolioPolicy(size=4))
        assert max_chain_correlation(feats, chain) <= max_chain_correlation(feats, naive) + 1e-9


def test_portfolio_cheaper_in_volatile_regime(volatile_sims):
    job = core.Job(48, 16)
    c_s = [sim.run_job(job, core.SiwoftPolicy()).total_cost for sim in volatile_sims]
    c_p = [sim.run_job(job, PortfolioPolicy()).total_cost for sim in volatile_sims]
    assert np.mean(c_p) < np.mean(c_s)


def test_portfolio_equivalent_in_calm_regime():
    ms = core.generate_markets(seed=0, n_hours=24 * 150)
    hist, fut = core.split_history_future(ms, 24 * 90)
    sim = core.Simulator(hist, fut, seed=0)
    job = core.Job(24, 16)
    a, b = sim.run_job(job, core.SiwoftPolicy()), sim.run_job(job, PortfolioPolicy())
    assert a.revocations == 0 and b.revocations == 0
    assert abs(a.total_cost - b.total_cost) / a.total_cost < 0.35
