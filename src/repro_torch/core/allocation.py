"""Multi-leg allocations: one job spread across several spot markets.

The paper's Algorithm 1 assumes one job ↔ one spot market, so a job whose
footprint exceeds every shape in the menu simply cannot be provisioned
without fault tolerance. Composing capacity from several markets at once
(Voorsluys, Garg & Buyya — *Provisioning Spot Market Cloud Resources to
Create Cost-effective Virtual Clusters*) removes that cliff: an
:class:`Allocation` is an ordered set of ``(market, device_count)``
**legs** plus the DCN bandwidth that couples them. A single-leg allocation
IS the paper's one-market provisioning — every downstream layer
(provisioner, simulator, orchestrator, accounting) must treat it
identically to the bare market index it replaces.

Physics of a split (all model-level; the provisioner prices it):

* **throughput** — the union device count scales sublinearly exactly like
  a single mesh (``repro.core.market.shape_throughput``), but the scaling
  exponent is set by the *effective* cross-leg bandwidth: the DCN egress,
  further capped by the slowest leg's interconnect (a collective cannot
  drain a leg faster than that leg's own fabric). A split is therefore
  never faster than the same devices behind one interconnect.
* **survival** — any leg revocation interrupts the job, so an
  allocation's MTTR composes as the **min** over its legs' MTTRs. Wider
  splits face a strictly harder admission test; that is the honest model,
  not a penalty knob.
* **price** — legs bill independently ($/h of each leg's market), so the
  allocation's hourly price is the sum over legs and the accounting layer
  carries a per-leg cost breakdown that must sum to the total.
"""
from __future__ import annotations

import dataclasses
from typing import Iterable, Sequence, Tuple

from repro_torch.core.market import shape_throughput

# Cross-market egress (GB/s) over the data-center network. Device
# interconnects in the menu run 10–60 GB/s; crossing markets means leaving
# the instance fabric, so a split mesh's collectives drain at DCN speed —
# the discount that keeps a split from ever beating the same devices on
# one interconnect.
DCN_BANDWIDTH_GBPS = 2.5


@dataclasses.dataclass(frozen=True)
class Leg:
    """One leg of an allocation: ``device_count`` devices in ``market``."""

    market: int
    device_count: int = 1


@dataclasses.dataclass(frozen=True)
class Allocation:
    """An ordered set of legs provisioned together for one job.

    Hashable and order-preserving: the leg order is the mesh-construction
    order (`dist.meshplan.plan_for_allocation` assigns device spans in leg
    order), and two allocations with the same legs in the same order are
    the same allocation.
    """

    legs: Tuple[Leg, ...]
    dcn_gbps: float = DCN_BANDWIDTH_GBPS

    def __post_init__(self):
        assert self.legs, "an allocation has at least one leg"
        assert len({l.market for l in self.legs}) == len(self.legs), (
            "one spot request per market: legs must name distinct markets"
        )

    @classmethod
    def single(cls, market: int, device_count: int = 1,
               dcn_gbps: float = DCN_BANDWIDTH_GBPS) -> "Allocation":
        """The degenerate one-market allocation — the paper's setting."""
        return cls(legs=(Leg(int(market), int(device_count)),), dcn_gbps=dcn_gbps)

    @classmethod
    def of(cls, markets: Iterable[int], device_counts: Iterable[int],
           dcn_gbps: float = DCN_BANDWIDTH_GBPS) -> "Allocation":
        return cls(
            legs=tuple(Leg(int(m), int(d)) for m, d in zip(markets, device_counts)),
            dcn_gbps=dcn_gbps,
        )

    def __len__(self) -> int:
        return len(self.legs)

    @property
    def markets(self) -> Tuple[int, ...]:
        return tuple(l.market for l in self.legs)

    @property
    def device_counts(self) -> Tuple[int, ...]:
        return tuple(l.device_count for l in self.legs)

    @property
    def total_devices(self) -> int:
        return sum(l.device_count for l in self.legs)

    @property
    def is_split(self) -> bool:
        return len(self.legs) > 1

    def touches(self, market: int) -> bool:
        return any(l.market == market for l in self.legs)

    def surviving(self, revoked_market: int) -> Tuple[Leg, ...]:
        """The legs that outlive a revocation of ``revoked_market``."""
        return tuple(l for l in self.legs if l.market != revoked_market)

    def replace_leg(self, revoked_market: int, new_leg: Leg) -> "Allocation":
        """The repaired allocation: the revoked leg swapped in place for
        ``new_leg`` — the partial-reshard re-provisioning primitive."""
        assert self.touches(revoked_market)
        return Allocation(
            legs=tuple(
                new_leg if l.market == revoked_market else l for l in self.legs
            ),
            dcn_gbps=self.dcn_gbps,
        )


def combined_throughput(
    device_counts: Sequence[int],
    interconnects_gbps: Sequence[float],
    dcn_gbps: float = DCN_BANDWIDTH_GBPS,
) -> float:
    """Relative steps/hour of a multi-leg mesh over DCN.

    The union device count scales by the same sublinear law as a single
    mesh, but at the effective bandwidth ``min(dcn, slowest leg egress)``:
    the cross-leg collective both crosses the DCN and drains through each
    leg's own fabric, so the slowest of those pipes sets the exponent.
    Properties (pinned by tests/test_allocation.py):

    * one leg → exactly ``shape_throughput(n, interconnect)`` (no DCN in
      the path — the single-market physics, bit-identical),
    * never better than the same devices behind any single leg's
      interconnect (α is non-decreasing in bandwidth and the effective
      bandwidth is a min),
    * still strictly more work/hour than the bigger leg alone whenever the
      DCN is not absurdly slow — which is what makes a split worth pricing.
    """
    counts = [int(c) for c in device_counts]
    assert counts and all(c >= 1 for c in counts)
    if len(counts) == 1:
        return shape_throughput(counts[0], float(interconnects_gbps[0]))
    eff_bw = min(float(dcn_gbps), min(float(b) for b in interconnects_gbps))
    return shape_throughput(sum(counts), eff_bw)
