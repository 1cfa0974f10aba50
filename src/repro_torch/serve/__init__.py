"""``repro_torch.serve`` — SLO-aware spot provisioning for inference fleets
(port of ``repro.serve``, with the same exports).

The serving face of the paper's thesis: instead of admitting a batch job
whose wall time an MTTR must dominate, the fleet provisioner admits
replica markets whose MTTR dominates a rolling SLO horizon, spreads
replicas across low-correlation markets, and treats a revocation as a
params-only live migration — availability from market diversity, not
from redundancy mechanisms.

* :mod:`repro_torch.serve.fleet`   — fleet sizing, admission, diversity, the
  trace-driven fleet simulator and its baselines;
* :mod:`repro_torch.serve.router`  — the deterministic open-loop request queue
  (served/shed tokens, SLO-violation clock, exact token conservation);
* :mod:`repro_torch.serve.migrate` — the params-only migration cost model and
  the live reshard helpers ``launch/serve.py --plan`` drives for real;
* :mod:`repro_torch.serve.engine`  — the continuous-batching decode engine over
  the paged KV pool (the replica hot path whose measured tokens/sec the
  fleet simulator consumes in ``throughput_mode="engine"``);
* :mod:`repro_torch.serve.autoscale` — the demand-driven scaler
  (forecast-ahead scale-up, low-water scale-down with cooldown) behind
  ``FleetSimulator(sizing="auto")`` and the engine drain helper.
"""
from repro_torch.serve.autoscale import (
    AutoscalePolicy,
    AutoScaler,
    ScaleDecision,
    drain_replica,
)
from repro_torch.serve.engine import Completion, DecodeEngine, Request
from repro_torch.serve.fleet import (
    FleetPlan,
    FleetReport,
    FleetSimulator,
    Replica,
    ServePolicy,
    ServingWorkload,
    on_demand_reference,
    provision_fleet,
    repair_fleet,
    replica_rate,
)
from repro_torch.serve.migrate import MigrationCost, migration_cost
from repro_torch.serve.router import (
    CapacityEvent,
    RouterStats,
    drain_interval,
    idle_headroom_tokens,
    route_trace,
)

__all__ = [
    "AutoScaler",
    "AutoscalePolicy",
    "CapacityEvent",
    "Completion",
    "DecodeEngine",
    "FleetPlan",
    "FleetReport",
    "FleetSimulator",
    "MigrationCost",
    "Replica",
    "Request",
    "RouterStats",
    "ScaleDecision",
    "ServePolicy",
    "ServingWorkload",
    "drain_interval",
    "drain_replica",
    "idle_headroom_tokens",
    "migration_cost",
    "on_demand_reference",
    "provision_fleet",
    "repair_fleet",
    "replica_rate",
    "route_trace",
]
