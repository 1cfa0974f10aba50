"""The port's copies of the JAX-free ``repro.core`` modules against the
reference, on the CPU: the same market sets bit for bit, the same
candidate sets and Algorithm-1 picks, the same bills (``==``)."""
import dataclasses

import numpy as np
import pytest

from repro.core import accounting as ref_acct
from repro.core import generate_markets as ref_generate_markets
from repro.core import provisioner as ref_alg
from repro.core import split_history_future as ref_split
from repro.core.policies import Job as RefJob
from repro.core.policies import SiwoftPolicy as RefPolicy
from repro_torch.core import accounting as acct
from repro_torch.core import generate_markets, split_history_future
from repro_torch.core import provisioner as alg
from repro_torch.core.policies import Job, SiwoftPolicy

HOURS = 24 * 90 + 24 * 30


def _markets(seed):
    ref = ref_split(ref_generate_markets(seed=seed, n_hours=HOURS), 24 * 90)
    port = split_history_future(generate_markets(seed=seed, n_hours=HOURS), 24 * 90)
    return ref, port


@pytest.mark.parametrize("seed", [3, 4])
def test_market_sets_are_bit_identical(seed):
    (rh, rf), (h, f) = _markets(seed)
    for r, p in ((rh, h), (rf, f)):
        assert r.prices.dtype == p.prices.dtype
        np.testing.assert_array_equal(r.prices, p.prices)
        np.testing.assert_array_equal(r.revocation_matrix(), p.revocation_matrix())
        assert r.start_hour == p.start_hour and r.n_hours == p.n_hours
        assert [dataclasses.asdict(m) for m in r.markets] == [
            dataclasses.asdict(m) for m in p.markets]


# (length hours, memory GB): small jobs that fit one shape, and footprints
# no single menu shape holds, which only a split admits
JOBS = [(0.3, 4.0), (5.0, 16.0), (48.0, 60.0), (200.0, 120.0), (12.0, 400.0), (30.0, 600.0)]


def _same_candidates(ref, port):
    key = lambda a: (a.markets, a.device_counts) if hasattr(a, "markets") else a
    return [key(a) for a in ref] == [key(a) for a in port]


@pytest.mark.parametrize("seed", [3, 4])
@pytest.mark.parametrize("hours,gb", JOBS)
def test_candidates_and_algorithm1_pick_agree(seed, hours, gb):
    (rh, _), (h, _) = _markets(seed)
    rfeat, feat = ref_alg.MarketFeatures.from_history(rh), alg.MarketFeatures.from_history(h)
    for field in dataclasses.fields(rfeat):
        np.testing.assert_array_equal(np.asarray(getattr(rfeat, field.name)),
                                      np.asarray(getattr(feat, field.name)))
    rjob, job = RefJob(length_hours=hours, memory_gb=gb), Job(length_hours=hours, memory_gb=gb)
    rpol, pol = RefPolicy(), SiwoftPolicy()
    assert ref_alg.find_suitable_servers(rjob, rfeat) == alg.find_suitable_servers(job, feat)
    rsuit = ref_alg.find_suitable_allocations(rjob, rfeat, rpol)
    suit = alg.find_suitable_allocations(job, feat, pol)
    assert suit and _same_candidates(rsuit, suit)
    rS = ref_alg.server_based_lifetime(
        rjob, ref_alg.compute_allocation_lifetimes(rfeat, rsuit), rpol, rfeat)
    S = alg.server_based_lifetime(job, alg.compute_allocation_lifetimes(feat, suit), pol, feat)
    assert _same_candidates(rS, S)
    rpick, pick = ref_alg.highest(rS), alg.highest(S)
    assert (rpick.markets, rpick.device_counts) == (pick.markets, pick.device_counts)
    assert ref_alg.allocation_expected_cost_to_complete(hours, rfeat, rpick) == \
        alg.allocation_expected_cost_to_complete(hours, feat, pick)


def _sessions(mod, n_markets):
    """Sessions that exercise every billing path: one leg, split legs,
    staggered anchors with a deferred leg, and fractional starts."""
    return [
        mod.Session(2, 0.25, [("startup", 0.05), ("execution", 1.7), ("re_execution", 0.2)]),
        mod.Session(5, 3.9, [("startup", 0.05), ("reshard", 0.01), ("execution", 0.4)],
                    legs=(5, 7)),
        mod.Session(1, 7.3, [("recovery", 0.3), ("execution", 2.25)], legs=(1, 4, 6),
                    leg_anchors=(6.1, 7.3, 7.3), leg_releases=(True, False, True)),
        mod.Session(n_markets - 1, 11.0, [("startup", 0.05), ("execution", 0.95)]),
    ]


@pytest.mark.parametrize("seed", [3, 4])
def test_bills_and_breakdowns_are_equal(seed):
    (_, rf), (_, f) = _markets(seed)
    n = len(f.markets)
    for price_of in ((ref_acct.PriceTable(rf.prices), acct.PriceTable(f.prices)),
                     (lambda m, hr: float(rf.prices[m, min(hr, rf.n_hours - 1)]),
                      lambda m, hr: float(f.prices[m, min(hr, f.n_hours - 1)]))):
        rbd, bd = ref_acct.Breakdown(), acct.Breakdown()
        for rs, s in zip(_sessions(ref_acct, n), _sessions(acct, n)):
            assert ref_acct.bill_session(rs, price_of[0], rbd) == \
                acct.bill_session(s, price_of[1], bd)
        assert ref_acct.settle_leg(rbd, 4, 7.3, 9.85, price_of[0]) == \
            acct.settle_leg(bd, 4, 7.3, 9.85, price_of[1])
        assert dataclasses.asdict(rbd) == dataclasses.asdict(bd)
        assert rbd.total_cost == bd.total_cost and rbd.total_time == bd.total_time
        assert sum(bd.leg_cost.values()) == pytest.approx(bd.total_cost, rel=1e-12)
