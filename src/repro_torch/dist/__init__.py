"""``repro_torch.dist`` — placements over a pool of slots (port of
``repro.dist``).

Models describe every parameter with *logical* dim names and never name
mesh axes; :mod:`repro_torch.dist.sharding` resolves logical dims to mesh
axes through the reference's per-layout rule tables (``PARAM_RULES``),
giving a :class:`Placement` per leaf over a :class:`SlotMesh`;
:mod:`repro_torch.dist.elastic` moves live state onto a plan's device; and
:mod:`repro_torch.dist.meshplan` prices migrations: it turns the market's
instance menu into slot grids (``ElasticMeshManager``) and computes
``reshard_bytes`` (slice-overlap bytes a live reshard moves) against
``tree_bytes`` (what a checkpoint restore pulls through storage), with the
reference's numbers for the same shapes and placements.

A pool of N slots on one device simulates N devices: the placements decide
the byte accounting, execution is on the one device. Cache placements
(``cache_shardings``) price the dense cache a serving migration moves.
Batch and activation shardings have no effect there and are not ported,
nor are ``replicate`` and ``reshard_params``, which no caller of the port
needs yet.
"""
from repro_torch.dist.elastic import placement_device, reshard_tree
from repro_torch.dist.meshplan import (
    ElasticMeshManager,
    MeshPlan,
    ThroughputTracker,
    leg_state_bytes,
    mesh_shape_for,
    reshard_bytes,
    serve_state_bytes,
    train_state_bytes,
    tree_bytes,
)
from repro_torch.dist.sharding import (
    PARAM_RULES,
    Placement,
    SlotMesh,
    cache_shardings,
    opt_state_shardings,
    param_shardings,
    replicated,
    resolve_pspec,
)

__all__ = [
    "ElasticMeshManager",
    "MeshPlan",
    "PARAM_RULES",
    "Placement",
    "SlotMesh",
    "ThroughputTracker",
    "cache_shardings",
    "leg_state_bytes",
    "mesh_shape_for",
    "opt_state_shardings",
    "param_shardings",
    "placement_device",
    "replicated",
    "reshard_bytes",
    "reshard_tree",
    "resolve_pspec",
    "serve_state_bytes",
    "train_state_bytes",
    "tree_bytes",
]
