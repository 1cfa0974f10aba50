"""Provisioning policies and the fault-tolerance overhead model.

``OverheadModel`` holds the physical constants every policy shares
(checkpoint/restore bandwidth to remote storage, instance startup time, the
2-minute revocation notice, the 4 GB live-migration memory bound the paper
cites from SpotOn [4]).

Policies:

* ``SiwoftPolicy``      — the paper's contribution (Algorithm 1): highest-
                          MTTR market with MTTR ≥ 2×job length, restart from
                          scratch on revocation, re-provision only from the
                          low-correlation set. NO fault-tolerance mechanism.
* ``CheckpointPolicy``  — FT baseline: periodic checkpoints to remote
                          storage; revocation → new instance + restore +
                          re-execute from last checkpoint.
* ``MigrationPolicy``   — FT baseline: on the 2-minute notice, live-migrate
                          if the footprint fits the notice window, else the
                          revocation behaves like an unplanned kill.
* ``ReplicationPolicy`` — FT baseline: k replicas on distinct markets; the
                          job restarts from scratch only if ALL replicas die.
* ``OnDemandPolicy``    — reference: on-demand instance, no revocations.
"""
from __future__ import annotations

import dataclasses
from typing import Optional

from repro_torch.core.units import BYTES_PER_GB, MINUTES_PER_HOUR, SECONDS_PER_HOUR


@dataclasses.dataclass(frozen=True)
class OverheadModel:
    startup_hours: float = 150.0 / SECONDS_PER_HOUR  # boot + docker pull ≈ 2.5 min
    ckpt_bandwidth_gb_per_s: float = 0.05        # single-stream S3 ≈ 50 MB/s
    restore_bandwidth_gb_per_s: float = 0.05
    migration_bandwidth_gb_per_s: float = 1.0    # instance-to-instance
    live_migration_max_gb: float = 4.0           # paper cites SpotOn's bound
    revocation_notice_hours: float = 2.0 / MINUTES_PER_HOUR  # EC2's 2-minute warning
    storage_cost_per_gb_hour: float = 0.0        # S3 cost negligible vs compute

    def ckpt_hours(self, mem_gb: float) -> float:
        return mem_gb / self.ckpt_bandwidth_gb_per_s / SECONDS_PER_HOUR

    def restore_hours(self, mem_gb: float) -> float:
        return mem_gb / self.restore_bandwidth_gb_per_s / SECONDS_PER_HOUR

    def migration_hours(self, mem_gb: float) -> float:
        return mem_gb / self.migration_bandwidth_gb_per_s / SECONDS_PER_HOUR

    def reshard_hours(self, bytes_moved: float, interconnect_gbps: float) -> float:
        """Live cross-mesh reshard: bytes actually moved (leaf-by-leaf, see
        ``repro.dist.meshplan.reshard_bytes``) over the destination
        market's device interconnect — orders of magnitude faster than the
        remote-storage path ``restore_hours`` models."""
        if bytes_moved <= 0:
            return 0.0
        return bytes_moved / (max(interconnect_gbps, 1e-9) * BYTES_PER_GB) / SECONDS_PER_HOUR


def work_to_wall_hours(work_hours: float, throughput: float) -> float:
    """Wall-clock hours to complete ``work_hours`` of reference work at
    relative throughput θ — THE work↔wall conversion rule; every layer
    (provisioner admission, simulator progress, orchestrator billing)
    delegates here."""
    return float(work_hours) / max(float(throughput), 1e-9)


@dataclasses.dataclass(frozen=True)
class Job:
    """A batch job: pure-compute length (hours) and memory footprint (GB).

    ``length_hours`` is WORK, not wall time: hours of compute on the
    1-device reference shape (relative throughput 1.0). A market whose
    shape delivers throughput θ finishes the job in ``length_hours / θ``
    wall hours — see :meth:`wall_hours_on`. On a single-device menu
    (θ ≡ 1 everywhere) work and wall time coincide, which is the paper's
    setting."""

    length_hours: float
    memory_gb: float
    job_id: int = 0

    def wall_hours_on(self, throughput: float) -> float:
        """Wall-clock hours on a shape with relative throughput θ."""
        return work_to_wall_hours(self.length_hours, throughput)


@dataclasses.dataclass(frozen=True)
class SiwoftPolicy:
    name: str = "siwoft"
    lifetime_factor: float = 2.0        # Alg.1 step 8: MTTR ≥ 2 × job length
    correlation_threshold: float = 0.2  # "low revocation correlation" cut
    # beyond-paper hybrid: also checkpoint every `ckpt_interval_hours` (0=off)
    ckpt_interval_hours: float = 0.0
    # beyond-paper multi-leg allocations (core/allocation.py): a job whose
    # footprint fits no single menu shape splits across up to `max_legs`
    # spot markets (multi-leg mesh over DCN). `split_margin=None` keeps the
    # split search strictly as a fallback — single-market behavior is then
    # bit-identical to the pre-allocation provisioner; a float in (0, 1)
    # also admits opportunistic splits whose expected cost-to-complete
    # beats the best single shape by at least that fraction.
    max_legs: int = 2
    split_margin: Optional[float] = None
    # pairwise co-revocation budget for split legs: EVERY pair of legs in a
    # candidate split must co-revoke below this cut (a split correlated
    # with itself revokes as one market but pays DCN prices). None -> the
    # step-13 `correlation_threshold` doubles as the budget. Three-leg
    # splits (`max_legs=3`) face the test over all three pairs, and their
    # MTTR still composes as min over legs — admission only gets harder.
    split_correlation_budget: Optional[float] = None

    @property
    def split_corr_cut(self) -> float:
        """The pairwise co-revocation cut the split search applies."""
        return (
            self.split_correlation_budget
            if self.split_correlation_budget is not None
            else self.correlation_threshold
        )

    @property
    def uses_checkpoints(self) -> bool:
        return self.ckpt_interval_hours > 0


@dataclasses.dataclass(frozen=True)
class CheckpointPolicy:
    name: str = "checkpoint"
    ckpt_interval_hours: float = 1.0    # "number of checkpoints" knob
    # the paper's FT baseline provisions "a spot instance" with no market
    # intelligence -> random suitable market; "cheapest" is a smarter variant
    market_selection: str = "random"


@dataclasses.dataclass(frozen=True)
class MigrationPolicy:
    name: str = "migration"
    market_selection: str = "random"


@dataclasses.dataclass(frozen=True)
class ReplicationPolicy:
    name: str = "replication"
    degree: int = 2
    market_selection: str = "random"


@dataclasses.dataclass(frozen=True)
class OnDemandPolicy:
    name: str = "on_demand"
