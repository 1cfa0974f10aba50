"""Beyond-paper: portfolio-driven provisioning (inspired by the paper's own
related work, Sharma et al., "Portfolio-driven resource management for
transient cloud servers" — reference [6] of the paper).

P-SIWOFT picks markets greedily by MTTR and only consults the correlation
feature reactively (AFTER a revocation). The portfolio policy instead
selects the whole failover chain UP FRONT by a mean-variance-style greedy
objective that trades expected lifetime against price and against
co-revocation with markets already in the portfolio:

    pick  argmax_m ( div(m|P),  log(MTTR_m) · div(m|P) / price_m^γ )   (lexicographic)
    div(m|P) = 1 − max_{p∈P} corr(m, p)

Diversity is the primary key because the heterogeneous instance menu
spans a ~4× absolute-price band: a scalar price-weighted score would let
a cheap-but-correlated shape outrank an uncorrelated one.

Execution semantics are identical to Algorithm 1 (no FT mechanism; restart
from scratch on revocation) — only the provisioning ORDER differs, so the
comparison isolates the value of proactive diversification. In calm markets
(rare-revocation markets exist) the two coincide on the first pick; the
portfolio wins in volatile regimes where consecutive failovers matter.
"""
from __future__ import annotations

import dataclasses
import math
from typing import List, Sequence


from repro_torch.core import provisioner as alg
from repro_torch.core.policies import Job, SiwoftPolicy
from repro_torch.core.provisioner import MarketFeatures


@dataclasses.dataclass(frozen=True)
class PortfolioPolicy(SiwoftPolicy):
    name: str = "portfolio"
    size: int = 4                 # failover-chain length selected up front
    price_gamma: float = 0.5      # price sensitivity in the greedy score
    lifetime_factor: float = 2.0


def select_portfolio(
    job: Job, feats: MarketFeatures, policy: PortfolioPolicy
) -> List[int]:
    """Greedy diversified failover chain over the suitable markets."""
    suitable = alg.find_suitable_servers(job, feats)
    lifetimes = alg.compute_lifetime(feats, suitable)
    admitted = [
        i for i in suitable
        if lifetimes[i] >= policy.lifetime_factor * job.length_hours
    ] or list(suitable)

    chain: List[int] = []
    rest = set(admitted)
    while rest and len(chain) < policy.size:
        def div(m: int) -> float:
            if not chain:
                return 1.0
            return 1.0 - max(float(feats.corr[m, p]) for p in chain)

        def score(m: int) -> float:
            # price per unit of WORK (the shape-throughput-normalized $/h):
            # a pricey fast mesh can outscore a cheap slow one
            price = max(
                float(feats.avg_price[m]) / max(float(feats.throughput[m]), 1e-9),
                1e-9,
            )
            return math.log(max(lifetimes[m], 1.001)) * max(div(m), 0.0) / price**policy.price_gamma

        # diversity first, lexicographically: the heterogeneous menu spans a
        # ~4x absolute-price band, so a price-weighted scalar score would let
        # a cheap-but-correlated shape outrank an uncorrelated one; price and
        # lifetime only arbitrate among equally-diversified candidates.
        best = max(sorted(rest), key=lambda m: (div(m), score(m)))
        chain.append(best)
        rest.discard(best)
    return chain


def portfolio_failover_order(
    job: Job, feats: MarketFeatures, policy: PortfolioPolicy
) -> List[int]:
    """The full provisioning order: the portfolio chain, then any remaining
    suitable markets MTTR-descending (the chain should rarely be exhausted)."""
    chain = select_portfolio(job, feats, policy)
    suitable = alg.find_suitable_servers(job, feats)
    lifetimes = alg.compute_lifetime(feats, suitable)
    tail = sorted(
        (i for i in suitable if i not in chain),
        key=lambda i: (
            -lifetimes[i],
            alg.expected_cost_to_complete(job.length_hours, feats, i),
            i,
        ),
    )
    return chain + tail


def max_chain_correlation(feats: MarketFeatures, chain: Sequence[int]) -> float:
    """Diagnostic: worst pairwise co-revocation within a chain prefix."""
    worst = 0.0
    for a in range(len(chain)):
        for b in range(a + 1, len(chain)):
            worst = max(worst, float(feats.corr[chain[a], chain[b]]))
    return worst
