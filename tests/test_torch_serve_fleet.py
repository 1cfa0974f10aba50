"""The port's serving fleet (``repro_torch.serve.{router,autoscale,migrate,
fleet}``, ``repro_torch.obs.{replay,export}``) against the JAX package's.

The modules are copies of JAX-free reference modules, so on the same
inputs every result must be EQUAL: every ``RouterStats`` field (delay
segments included), every scaler decision, every ``MigrationCost`` field,
every ``FleetPlan`` replica and every ``FleetReport`` field with its
``Breakdown`` — in mode fleet and static, sizing static and auto,
throughput analytic and engine, with and without a tracker. The
static-sizing fleet columns of the committed ``BENCH_serve.json`` come
out bit for bit, and traced fleet runs replay with 0 mismatches through
both replay oracles.
"""
import dataclasses
import json
import math
from pathlib import Path

from hypothesis import given, settings, strategies as st
import numpy as np
import pytest

from repro.core import generate_markets as ref_generate_markets
from repro.core import provisioner as ref_alg
from repro.core import split_history_future as ref_split
from repro.dist.meshplan import ThroughputTracker as RefTracker
from repro.obs import export as ref_export
from repro.obs import recorder as ref_recorder
from repro.obs import replay as ref_replay
from repro.serve import autoscale as ref_autoscale
from repro.serve import fleet as ref_fleet
from repro.serve import migrate as ref_migrate
from repro.serve import router as ref_router
from repro_torch.core import generate_markets, split_history_future
from repro_torch.core import provisioner as alg
from repro_torch.dist import ThroughputTracker, mesh_shape_for
from repro_torch.obs import export, recorder, replay
from repro_torch.serve import autoscale, fleet, migrate, router

REPO = Path(__file__).resolve().parents[1]
BENCH_HOURS = 312   # BENCH_serve.json's scenarios: 13 days


def _plain(x):
    """Dataclasses (of either package) as nested dicts, for ``==``."""
    if dataclasses.is_dataclass(x) and not isinstance(x, type):
        return {f.name: _plain(getattr(x, f.name)) for f in dataclasses.fields(x)}
    if isinstance(x, dict):
        return {k: _plain(v) for k, v in x.items()}
    if isinstance(x, (list, tuple)):
        return type(x)(_plain(v) for v in x)
    return x


def _report(rep) -> dict:
    """Every FleetReport field, the Breakdown's and the router's, and the
    derived columns the bench prints."""
    out = _plain(rep)
    out.update(cost=rep.cost_dollars, slo=rep.slo_violation_seconds,
               p50=rep.p50_delay_seconds, p99=rep.p99_delay_seconds)
    return out


# --- router -------------------------------------------------------------------

@settings(max_examples=40, deadline=None)
@given(
    st.floats(0, 1e4), st.floats(0, 500), st.floats(0, 500), st.floats(0.1, 7200),
    st.floats(1, 60), st.floats(60, 600),
)
def test_drain_interval_equals_reference_and_conserves(q0, a, c, T, slo, shed):
    kw = dict(max_delay_seconds=slo, shed_delay_seconds=shed)
    q, s = router.drain_interval(q0, a, c, T, **kw)
    rq, rs = ref_router.drain_interval(q0, a, c, T, **kw)
    assert q == rq and _plain(s) == _plain(rs)
    assert s.served_tokens + s.shed_tokens + s.q_end == pytest.approx(q0 + s.offered_tokens,
                                                                       rel=1e-9, abs=1e-6)


@settings(max_examples=25, deadline=None)
@given(
    st.lists(st.floats(0, 800), min_size=1, max_size=30),
    st.lists(st.tuples(st.floats(0.01, 30), st.floats(0, 900)), max_size=6),
    st.floats(0, 900),
)
def test_route_trace_equals_reference(rate, changes, cap0):
    """Random hourly traces through random capacity timelines: every
    RouterStats field, the percentiles and the idle headroom equal."""
    ev = [router.CapacityEvent(0.0, cap0)] + [router.CapacityEvent(t, c) for t, c in changes]
    ref_ev = [ref_router.CapacityEvent(e.at_hours, e.tokens_per_sec) for e in ev]
    kw = dict(max_delay_seconds=2.0, shed_delay_seconds=30.0)
    s = router.route_trace(rate, ev, **kw)
    rs = ref_router.route_trace(rate, ref_ev, **kw)
    assert _plain(s) == _plain(rs)
    assert (s.p50_delay_seconds, s.p99_delay_seconds) == (rs.p50_delay_seconds,
                                                          rs.p99_delay_seconds)
    assert router.idle_headroom_tokens(rate, ev) == ref_router.idle_headroom_tokens(rate, ref_ev)


# --- autoscaler and migration cost ----------------------------------------------

@settings(max_examples=25, deadline=None)
@given(st.lists(st.floats(0, 900), min_size=4, max_size=40),
       st.lists(st.floats(10, 300), min_size=1, max_size=6))
def test_autoscaler_decisions_equal_reference(rate, replica_rates):
    pol = dict(forecast_window_hours=3, low_water=0.5, cooldown_hours=2.0)
    ours = autoscale.AutoScaler(autoscale.AutoscalePolicy(**pol), capacity_headroom=1.25)
    ref = ref_autoscale.AutoScaler(ref_autoscale.AutoscalePolicy(**pol), capacity_headroom=1.25)
    for sc in (ours, ref):
        sc.record(0.0, "init")
    for h in range(len(rate)):
        d = ours.decide(float(h), replica_rates, forecast=ours.forecast(rate, h),
                        offered_now=rate[h])
        r = ref.decide(float(h), replica_rates, forecast=ref.forecast(rate, h),
                       offered_now=rate[h])
        assert (d.kind, d.target_tokens_per_sec) == (r.kind, r.target_tokens_per_sec)
        ours.record(float(h), d.kind)
        ref.record(float(h), r.kind)
    assert ours.events == ref.events


@pytest.mark.parametrize("policy", migrate.CACHE_POLICIES)
def test_migration_cost_equals_reference(policy):
    kw = dict(param_bytes=8_822_697_984, cache_bytes=2_396_913_664, cache_policy=policy,
              dcn_gbps=12.5, inflight_context_tokens=8 * 2048.0, prefill_tokens_per_sec=7e4)
    ours, ref = migrate.migration_cost(**kw), ref_migrate.migration_cost(**kw)
    assert _plain(ours) == _plain(ref)
    assert (ours.moved_bytes, ours.hours) == (ref.moved_bytes, ref.hours)
    assert ours.params_bytes < ours.train_path_bytes


# --- provisioning ---------------------------------------------------------------

def _setup(pkg_generate, pkg_split, pkg_fleet, seed=4, hours=24 * 14):
    ms = pkg_generate(seed=seed, n_hours=24 * 90 + hours)
    hist, fut = pkg_split(ms, 24 * 90)
    wl = pkg_fleet.ServingWorkload(target_tokens_per_sec=400.0, replica_tokens_per_sec=100.0,
                                   state_gb=20.0, param_bytes=200_000_000,
                                   cache_bytes=40_000_000)
    return hist, fut, wl


def _both_setups(**kw):
    return (_setup(generate_markets, split_history_future, fleet, **kw),
            _setup(ref_generate_markets, ref_split, ref_fleet, **kw))


@pytest.mark.parametrize("policy_kw", [dict(), dict(slo_horizon_hours=24.0, lifetime_factor=2.0),
                                       dict(slo_horizon_hours=1e6)],
                         ids=["default", "horizon24", "impossible"])
def test_provision_and_repair_fleet_equal_reference(policy_kw):
    (hist, _, wl), (rhist, _, rwl) = _both_setups()
    feats = alg.MarketFeatures.from_history(hist)
    rfeats = ref_alg.MarketFeatures.from_history(rhist)
    pol, rpol = fleet.ServePolicy(**policy_kw), ref_fleet.ServePolicy(**policy_kw)
    plan = fleet.provision_fleet(wl, feats, pol)
    rplan = ref_fleet.provision_fleet(rwl, rfeats, rpol)
    assert _plain(plan) == _plain(rplan)
    assert plan.capacity_tokens_per_sec == rplan.capacity_tokens_per_sec
    halved = fleet.provision_fleet(wl, feats, pol, rate_correction=lambda a: 0.5)
    rhalved = ref_fleet.provision_fleet(rwl, rfeats, rpol, rate_correction=lambda a: 0.5)
    assert _plain(halved) == _plain(rhalved)
    lost = plan.replicas[0]
    kw = dict(revoked_market=lost.allocation.markets[0],
              survivors=[m for r in plan.replicas[1:] for m in r.allocation.markets],
              exclude={lost.allocation.markets[0]})
    rep = fleet.repair_fleet(wl, feats, pol, lost=lost, **kw)
    rrep = ref_fleet.repair_fleet(rwl, rfeats, rpol, lost=rplan.replicas[0], **kw)
    assert rep is not None and _plain(rep) == _plain(rrep)
    grown = fleet.provision_fleet(dataclasses.replace(wl, target_tokens_per_sec=800.0), feats,
                                  pol, existing=plan.replicas)
    rgrown = ref_fleet.provision_fleet(dataclasses.replace(rwl, target_tokens_per_sec=800.0),
                                       rfeats, rpol, existing=rplan.replicas)
    assert _plain(grown) == _plain(rgrown)


# --- the simulator in every mode ------------------------------------------------

SIM_CASES = {
    "fleet-static-analytic": dict(),
    "fleet-auto-analytic": dict(sizing="auto"),
    "static-static-analytic": dict(mode="static"),
    "fleet-static-engine-equal": dict(throughput_mode="engine", measured_tokens_per_sec=100.0),
    "fleet-static-engine-slower": dict(throughput_mode="engine", measured_tokens_per_sec=61.5),
    "fleet-auto-engine-slower": dict(sizing="auto", throughput_mode="engine",
                                     measured_tokens_per_sec=61.5),
    "static-static-engine-slower": dict(mode="static", throughput_mode="engine",
                                        measured_tokens_per_sec=61.5),
    "fleet-static-tracker": dict(tracker=True),
    "fleet-auto-engine-tracker": dict(sizing="auto", throughput_mode="engine",
                                      measured_tokens_per_sec=80.0, tracker=True),
}


def _trackers():
    """The same observations in the port's and the reference's tracker: a
    4-slot plan measured at 0.8x its analytic rate, an 8-slot one at 1.3x."""
    from repro_torch.core.market import shape_throughput

    out = []
    for cls in (ThroughputTracker, RefTracker):
        t = cls()
        for n, f in ((4, 0.8), (8, 1.3)):
            t.observe((n, mesh_shape_for(n)), 1, 1.0 / (f * shape_throughput(n)))
        out.append(t)
    return out


def _bench_traces(hours):
    t = np.arange(hours, dtype=float)
    steady = np.full(hours, 350.0)
    steady[0] = 0.0
    diurnal = 300.0 - 180.0 * np.cos(2 * math.pi * ((t % 24) / 24.0))
    diurnal[0] = 0.0
    return {"steady": steady, "diurnal": diurnal}


@pytest.mark.parametrize("trace", ["steady", "diurnal"])
@pytest.mark.parametrize("case", sorted(SIM_CASES))
def test_fleet_simulator_equals_reference(case, trace):
    """Every FleetReport field equal (==) on the serve bench's market set
    and traces at its quick length (3 days)."""
    kw = dict(SIM_CASES[case])
    hours = 72
    (hist, fut, wl), (rhist, rfut, rwl) = _both_setups(hours=hours + 24)
    rate = _bench_traces(hours)[trace]
    pol = dict(slo_horizon_hours=24.0, capacity_headroom=1.25, cache_policy="drop")
    rkw = dict(kw)
    if kw.get("tracker"):
        kw["tracker"], rkw["tracker"] = _trackers()
    ours = fleet.FleetSimulator(hist, fut, wl, fleet.ServePolicy(**pol), **kw).run(
        float(hours), rate)
    ref = ref_fleet.FleetSimulator(rhist, rfut, rwl, ref_fleet.ServePolicy(**pol), **rkw).run(
        float(hours), rate)
    assert _report(ours) == _report(ref)
    assert ours.router.served_tokens + ours.router.shed_tokens + ours.router.q_end == \
        pytest.approx(ours.router.offered_tokens, rel=1e-12)


@settings(max_examples=6, deadline=None)
@given(st.lists(st.floats(0, 900), min_size=48, max_size=48),
       st.sampled_from(["fleet-static-analytic", "fleet-auto-analytic", "static-static-analytic",
                        "fleet-auto-engine-slower"]))
def test_fleet_simulator_equals_reference_on_random_traces(rate, case):
    (hist, fut, wl), (rhist, rfut, rwl) = _both_setups(hours=72)
    rate = np.asarray(rate)
    pol = dict(slo_horizon_hours=12.0, capacity_headroom=1.4)
    ours = fleet.FleetSimulator(hist, fut, wl, fleet.ServePolicy(**pol), **SIM_CASES[case]).run(
        48.0, rate)
    ref = ref_fleet.FleetSimulator(rhist, rfut, rwl, ref_fleet.ServePolicy(**pol),
                                   **SIM_CASES[case]).run(48.0, rate)
    assert _report(ours) == _report(ref)


def test_on_demand_reference_equals_reference():
    (hist, fut, wl), (rhist, rfut, rwl) = _both_setups(hours=96)
    rate = _bench_traces(72)["diurnal"]
    pol = dict(slo_horizon_hours=24.0, capacity_headroom=1.25)
    ours = fleet.on_demand_reference(wl, alg.MarketFeatures.from_history(hist), fut, 72.0,
                                     rate, fleet.ServePolicy(**pol))
    ref = ref_fleet.on_demand_reference(rwl, ref_alg.MarketFeatures.from_history(rhist), rfut,
                                        72.0, rate, ref_fleet.ServePolicy(**pol))
    assert _report(ours) == _report(ref)


def test_engine_mode_requires_measured_rate():
    (hist, fut, wl), _ = _both_setups(hours=48)
    with pytest.raises(ValueError):
        fleet.FleetSimulator(hist, fut, wl, fleet.ServePolicy(), throughput_mode="engine")


# --- the committed bench, bit for bit --------------------------------------------

def _bench_workload():
    """benchmarks/serve_bench.py's workload, from the port's reduced model."""
    from repro_torch.config import get_arch
    from repro_torch.core.units import BYTES_PER_GIB
    from repro_torch.dist import serve_state_bytes
    from repro_torch.models import build_model
    from repro_torch.models.common import param_bytes

    model = build_model(get_arch("qwen3-4b").reduced())
    pb = param_bytes(model.specs)
    sb = serve_state_bytes(model, batch=4, seq_len=256)
    return fleet.ServingWorkload(target_tokens_per_sec=480.0, replica_tokens_per_sec=100.0,
                                 state_gb=sb / BYTES_PER_GIB, param_bytes=pb,
                                 cache_bytes=sb - pb, inflight_context_tokens=4 * 256.0)


def _bench_columns(rep) -> dict:
    """benchmarks/serve_bench.py::rep_json's columns and rounding."""
    return {
        "cost_usd": round(rep.cost_dollars, 6),
        "slo_violation_seconds": round(rep.slo_violation_seconds, 3),
        "served_tokens": round(rep.router.served_tokens, 1),
        "shed_tokens": round(rep.router.shed_tokens, 1),
        "queued_token_seconds": round(rep.router.queued_token_seconds, 1),
        "p50_delay_seconds": round(rep.p50_delay_seconds, 4),
        "p99_delay_seconds": round(rep.p99_delay_seconds, 4),
        "revocations": rep.revocations,
        "repairs": rep.repairs,
        "migrated_bytes": rep.migrated_bytes,
        "restored_bytes": rep.restored_bytes,
        "replicas_provisioned": rep.replicas_provisioned,
        "scale_ups": rep.scale_ups,
        "scale_downs": rep.scale_downs,
        "idle_headroom_tokens": round(rep.idle_headroom_tokens, 1),
        "capacity_tokens_per_sec": round(rep.capacity_tokens_per_sec, 3),
        "billing_buffer_usd": round(rep.breakdown.cost["billing_buffer"], 6),
    }


@pytest.mark.parametrize("scenario", ["steady", "diurnal"])
def test_static_sizing_reproduces_committed_bench_fleet_columns(scenario):
    """The port's static-sizing fleet run reproduces BENCH_serve.json's
    ``fleet`` columns bit for bit (the reference pins the same in
    tests/test_serve_fleet.py)."""
    bench = json.loads((REPO / "BENCH_serve.json").read_text())
    want = next(s for s in bench["scenarios"] if s["name"] == scenario)
    assert want["hours"] == BENCH_HOURS
    wl = _bench_workload()
    assert (wl.param_bytes, wl.cache_bytes) == (bench["workload"]["param_bytes"],
                                                bench["workload"]["cache_bytes"])
    ms = generate_markets(seed=4, n_hours=24 * 90 + BENCH_HOURS + 24)
    hist, fut = split_history_future(ms, 24 * 90)
    pol = fleet.ServePolicy(slo_horizon_hours=24.0, capacity_headroom=1.25, cache_policy="drop")
    sim = fleet.FleetSimulator(hist, fut, wl, pol)
    assert sim.sizing == "static"
    rep = sim.run(float(BENCH_HOURS), _bench_traces(BENCH_HOURS)[scenario])
    assert _bench_columns(rep) == want["policies"]["fleet"]


# --- traces: replay and export ----------------------------------------------------

def _traced_runs(pkg_fleet, pkg_recorder, setup, hours=72):
    hist, fut, wl = setup
    rate = _bench_traces(hours)["diurnal"]
    pol = pkg_fleet.ServePolicy(slo_horizon_hours=24.0, capacity_headroom=1.25)
    with pkg_recorder.recording() as rec:
        for kw in (dict(), dict(sizing="auto"), dict(mode="static")):
            pkg_fleet.FleetSimulator(hist, fut, wl, pol, **kw).run(float(hours), rate)
    return rec.events


@pytest.fixture(scope="module")
def traces():
    ours_setup, ref_setup = _both_setups(hours=96)
    return (_traced_runs(fleet, recorder, ours_setup),
            _traced_runs(ref_fleet, ref_recorder, ref_setup))


def test_traced_fleet_runs_replay_through_both_oracles(traces, tmp_path):
    ours, ref = traces
    path = tmp_path / "fleet.jsonl"
    assert export.write_jsonl(path, ours) == len(ours)
    assert [e.__class__.__name__ for e in ours] == [e.__class__.__name__ for e in ref]
    for oracle, reader in ((replay, export.read_jsonl), (ref_replay, ref_export.read_jsonl)):
        runs, problems = oracle.verify_events(reader(path))
        assert len(runs) == 3 and all(r.pin is not None for r in runs)
        assert problems == []
    assert replay.main([str(path)]) == 0 and ref_replay.main([str(path)]) == 0


def test_replay_cli_fails_on_a_tampered_pin(traces, tmp_path):
    ours, _ = traces
    i = max(k for k, e in enumerate(ours) if type(e).__name__ == "BreakdownPin")
    bad = list(ours)
    bad[i] = dataclasses.replace(bad[i], served_tokens=bad[i].served_tokens + 1.0)
    path = tmp_path / "bad.jsonl"
    export.write_jsonl(path, bad)
    assert replay.main([str(path)]) == 1


def test_chrome_trace_equals_reference(traces, tmp_path):
    ours, _ = traces
    path = tmp_path / "fleet.jsonl"
    export.write_jsonl(path, ours)
    mine = export.to_chrome_trace(export.read_jsonl(path))
    theirs = ref_export.to_chrome_trace(ref_export.read_jsonl(path))
    assert mine == theirs and mine["traceEvents"]
    assert export.main([str(path), "-o", str(tmp_path / "c.json")]) == 0
    assert json.loads((tmp_path / "c.json").read_text()) == mine
