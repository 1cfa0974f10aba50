"""``repro_torch.dist`` — placements over a pool of slots (port of
``repro.dist``).

Models describe every parameter with *logical* dim names and never name
mesh axes; :mod:`repro_torch.dist.sharding` resolves logical dims to mesh
axes through the reference's per-layout rule tables (``PARAM_RULES``),
giving a :class:`Placement` per leaf over a :class:`SlotMesh`;
:mod:`repro_torch.dist.elastic` moves live state between placements; and
:mod:`repro_torch.dist.meshplan` prices migrations: it turns the market's
instance menu into slot grids (``ElasticMeshManager``) and computes
``reshard_bytes`` (slice-overlap bytes a live reshard moves) against
``tree_bytes`` (what a checkpoint restore pulls through storage), with the
reference's numbers for the same shapes and placements.

Two kinds of pool. Over the ranks of a ``torch.distributed`` world
(``repro_torch.launch.mesh``; NCCL on the cards, gloo on the CPU) a slot
is a process and a device, each rank holds its slices, and a reshard moves
exactly the bytes ``reshard_bytes`` prices: the training state between
plans, and a serving replica's params and, under the ``migrate`` cache
policy, its dense cache (``cache_shardings``), which a rank then gathers
to the rows it decodes (``rows_shardings``, ``gather_tree``). In one
process, a pool of N slots on one device simulates N devices: the
placements decide the byte accounting, execution is on the one device,
and a serving migration's cache is priced and copied on that device.
Activation shardings (``make_activation_constrainer``) need
tensor-parallel compute, which the port does not have, and are not
ported.
"""
from repro_torch.dist.elastic import (
    gather_tree,
    move_leaves,
    narrow_tree,
    placement_device,
    rebuild_legs,
    replicate,
    reshard_params,
    reshard_tree,
)
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
    batch_shardings,
    cache_shardings,
    opt_state_shardings,
    param_shardings,
    rank_mesh,
    replicated,
    resolve_pspec,
    rows_shardings,
)

__all__ = [
    "ElasticMeshManager",
    "MeshPlan",
    "PARAM_RULES",
    "Placement",
    "SlotMesh",
    "ThroughputTracker",
    "batch_shardings",
    "cache_shardings",
    "gather_tree",
    "leg_state_bytes",
    "mesh_shape_for",
    "move_leaves",
    "narrow_tree",
    "opt_state_shardings",
    "param_shardings",
    "placement_device",
    "rank_mesh",
    "rebuild_legs",
    "replicate",
    "replicated",
    "reshard_bytes",
    "reshard_params",
    "reshard_tree",
    "resolve_pspec",
    "rows_shardings",
    "serve_state_bytes",
    "train_state_bytes",
    "tree_bytes",
]
