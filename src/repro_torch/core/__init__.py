"""The paper's provisioner in the port: copies of the JAX-free modules of
``repro.core`` (units, markets, allocations, policies, Algorithm 1,
accounting; only their imports differ) and ``orchestrator.py``, which
drives the port's training loop. ``Simulator`` and ``PortfolioPolicy`` are
not copied yet.

market.py       spot markets, price traces, MTTR / correlation features
provisioner.py  Algorithm 1, step-for-step
policies.py     P-SIWOFT + FT baselines (checkpoint / migration / replication)
accounting.py   per-billing-cycle cost/time breakdowns
orchestrator.py bridges the provisioner to the port's training loop
"""
from repro_torch.core.accounting import Breakdown, PriceTable
from repro_torch.core.allocation import (
    DCN_BANDWIDTH_GBPS,
    Allocation,
    Leg,
    combined_throughput,
)
from repro_torch.core.market import (
    INSTANCE_MENU,
    InstanceShape,
    Market,
    MarketSet,
    generate_markets,
    generate_markets_scalar,
    legacy_menu,
    load_csv_traces,
    next_revocation_scalar,
    next_revocation_table,
    revocation_probability,
    shape_throughput,
    split_history_future,
)
from repro_torch.core.policies import (
    CheckpointPolicy,
    Job,
    MigrationPolicy,
    OnDemandPolicy,
    OverheadModel,
    ReplicationPolicy,
    SiwoftPolicy,
)
from repro_torch.core.provisioner import (
    MarketFeatures,
    allocation_expected_cost_to_complete,
    allocation_throughput,
    cost_to_complete,
    expected_cost_to_complete,
    find_suitable_allocations,
)

__all__ = [
    "INSTANCE_MENU", "InstanceShape",
    "Market", "MarketSet", "generate_markets", "generate_markets_scalar",
    "legacy_menu", "load_csv_traces", "next_revocation_scalar",
    "next_revocation_table", "revocation_probability", "shape_throughput",
    "split_history_future", "PriceTable",
    "CheckpointPolicy", "Job", "MigrationPolicy", "OnDemandPolicy",
    "OverheadModel", "ReplicationPolicy", "SiwoftPolicy",
    "MarketFeatures", "Breakdown",
    "cost_to_complete", "expected_cost_to_complete",
    "Allocation", "Leg", "DCN_BANDWIDTH_GBPS", "combined_throughput",
    "find_suitable_allocations", "allocation_throughput",
    "allocation_expected_cost_to_complete",
]
