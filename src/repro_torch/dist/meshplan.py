"""Mesh planning for market-menu elastic provisioning (port of
``repro.dist.meshplan``).

The provisioner's instance menu (``repro_torch.core.market.InstanceShape``)
describes each market as ``device_count`` accelerators behind an
interconnect; this module turns that description into a plan the training
stack can run on and *price*:

* :func:`mesh_shape_for` — deterministic (data, model) factorization of a
  device count (1→(1,1), 2→(2,1), 4→(2,2), 8→(4,2)),
* :class:`MeshPlan` / :class:`ElasticMeshManager` — one slot grid
  (:class:`~repro_torch.dist.sharding.SlotMesh`) per honored device count,
  from a pool of slots. The pool defaults to ``[cuda:0]``; a pool of N
  slots on one card *simulates* N federated devices, as the reference's
  forced host devices do. Placements over the grid decide the byte
  accounting; execution is on the pool's one device,
* :func:`reshard_bytes` — the byte-level cost of a live cross-mesh
  reshard: for every leaf, every destination slot pays only for the slice
  elements it does not already hold under the source placement. Identical
  placements cost 0 bytes; any migration costs at most :func:`tree_bytes`,
  the full state a checkpoint restore pulls through remote storage.

Leaves only need ``.shape`` and ``.dtype`` (tensors, ``ParamSpec``s); a
Python int leaf (the train state's ``step`` and moment ``count``) counts
as the int32 scalar the reference and the checkpoint store. Torch tensors
carry no placement, so the reference's ``live_shardings`` has no
counterpart: the caller keeps the state's placement tree beside it.
"""
from __future__ import annotations

import dataclasses
from typing import Any, Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch

from repro_torch.dist.sharding import Placement, SlotMesh
from repro_torch.models.common import param_bytes, torch_dtype, tree_flatten


def mesh_shape_for(n_devices: int) -> Tuple[int, int]:
    """Deterministic (data, model) factorization of ``n_devices``."""
    n = max(int(n_devices), 1)
    # model axis: largest power of two m with m*m <= n and n % m == 0
    m = 1
    while (m * 2) * (m * 2) <= n and n % (m * 2) == 0:
        m *= 2
    return (n // m, m)


@dataclasses.dataclass(frozen=True)
class MeshPlan:
    """One menu shape — or one multi-leg allocation — made concrete on the
    slot pool. ``leg_spans`` maps each allocation leg to its contiguous
    range of positions in ``mesh.slots``; single-market plans have one span
    covering the whole grid."""

    requested_devices: int          # the menu's device_count
    device_count: int               # honored (capped to the pool)
    mesh_shape: Tuple[int, int]     # (data, model)
    axes: Tuple[str, str]
    mesh: SlotMesh
    leg_spans: Tuple[Tuple[int, int], ...] = ()

    def __post_init__(self):
        if not self.leg_spans:
            object.__setattr__(self, "leg_spans", ((0, self.device_count),))

    @property
    def key(self) -> Tuple[int, Tuple[int, int]]:
        """Identity of the *execution* substrate (honored count + shape).

        Deliberately leg-blind: a 4+4 split and a single 8-device market
        give the SAME grid, so re-provisioning between them reuses the step
        and moves zero bytes of layout — only the DCN-crossing leg bytes
        (``leg_state_bytes``) differ, and those are billed by the
        orchestrator."""
        return (self.device_count, self.mesh_shape)


class ElasticMeshManager:
    """Builds and caches one slot grid per honored device count.

    The pool is a list of slots, each naming a torch device (default
    ``[cuda:0]``); a menu shape asking for more devices than the pool holds
    is capped — two menu shapes that cap to the same count share one plan,
    so re-provisioning between them is a zero-byte reshard.
    """

    def __init__(self, devices: Optional[Sequence[Any]] = None):
        pool = devices if devices is not None else [torch.device("cuda", 0)]
        self.devices: List[torch.device] = [torch.device(d) for d in pool]
        self._plans: Dict[int, MeshPlan] = {}
        self._alloc_plans: Dict[Tuple[int, ...], MeshPlan] = {}

    def _mesh(self, n: int, shape: Tuple[int, int]) -> SlotMesh:
        return SlotMesh(grid_shape=shape, axis_names=("data", "model"),
                        slots=tuple(range(n)), devices=tuple(self.devices[:n]))

    def plan_for(self, device_count: int) -> MeshPlan:
        n = max(1, min(int(device_count), len(self.devices)))
        plan = self._plans.get(n)
        if plan is None:
            shape = mesh_shape_for(n)
            plan = MeshPlan(
                requested_devices=int(device_count),
                device_count=n,
                mesh_shape=shape,
                axes=("data", "model"),
                mesh=self._mesh(n, shape),
            )
            self._plans[n] = plan
        return plan

    def plan_for_allocation(self, device_counts: Sequence[int]) -> MeshPlan:
        """One grid spanning every leg of a multi-leg allocation.

        The union grid is built over the summed device count (capped to the
        pool — the pool *simulates* the federated instances) with
        contiguous per-leg slot spans recorded in ``leg_spans``; honored
        leg sizes are the proportional split of the capped total, so an
        (8, 8) allocation on an 8-slot pool simulates as (4, 4). A
        single-leg allocation delegates to :meth:`plan_for`. When the pool
        has fewer slots than the allocation has legs, trailing legs
        collapse to empty spans (byte accounting then degenerates to zero
        for those legs)."""
        counts = [max(int(c), 1) for c in device_counts]
        if len(counts) == 1:
            return self.plan_for(counts[0])
        total = sum(counts)
        honored_total = max(1, min(total, len(self.devices)))
        # proportional, deterministic rounding: floor shares, then hand the
        # remainder to the widest legs first (ties: leg order)
        shares = [honored_total * c // total for c in counts]
        rest = honored_total - sum(shares)
        order = sorted(range(len(counts)), key=lambda i: (-counts[i], i))
        for i in order:
            if rest <= 0:
                break
            shares[i] += 1
            rest -= 1
        key = tuple(shares)
        plan = self._alloc_plans.get(key)
        if plan is None:
            shape = mesh_shape_for(honored_total)
            spans, lo = [], 0
            for s in shares:
                spans.append((lo, lo + s))
                lo += s
            plan = MeshPlan(
                requested_devices=int(total),
                device_count=honored_total,
                mesh_shape=shape,
                axes=("data", "model"),
                mesh=self._mesh(honored_total, shape),
                leg_spans=tuple(spans),
            )
            self._alloc_plans[key] = plan
        return plan


# ---------------------------------------------------------------------------
# Measured throughput per mesh shape
# ---------------------------------------------------------------------------

class ThroughputTracker:
    """EMA of measured steps/sec per :attr:`MeshPlan.key`.

    The provisioner's menu predicts each shape's relative speed analytically
    (``repro_torch.core.market.shape_throughput``); the orchestrator records
    what ``run_segment`` actually delivered per mesh shape here and uses
    :meth:`correction` to scale the analytic prediction by the measured
    deviation — so a shape that scales worse than the model's efficiency
    exponent stops looking cheap-per-step after one segment on it.
    """

    def __init__(self, ema: float = 0.5):
        self.ema = ema
        self._sps: Dict[Any, float] = {}

    def observe(self, key, steps: int, seconds: float) -> None:
        if steps <= 0 or seconds <= 0:
            return
        sps = steps / seconds
        prev = self._sps.get(key)
        self._sps[key] = sps if prev is None else self.ema * sps + (1 - self.ema) * prev

    def steps_per_sec(self, key) -> Optional[float]:
        return self._sps.get(key)

    @property
    def measured(self) -> Dict[Any, float]:
        return dict(self._sps)

    def correction(self, key, analytic: Dict[Any, float]) -> float:
        """Measured-vs-analytic speed ratio for ``key``, relative to the
        slowest-predicted observed shape (which anchors the scale).

        ``analytic`` maps plan keys to the model's predicted relative
        throughput. Returns 1.0 until two distinct shapes have been
        measured — a single observation fixes the anchor, not a ratio."""
        if key not in self._sps or len(self._sps) < 2:
            return 1.0
        ref = min(self._sps, key=lambda k: analytic.get(k, 1.0))
        if ref == key:
            return 1.0
        predicted = analytic.get(key, 1.0) / max(analytic.get(ref, 1.0), 1e-9)
        observed = self._sps[key] / max(self._sps[ref], 1e-9)
        return observed / max(predicted, 1e-9)


# ---------------------------------------------------------------------------
# Byte-level reshard cost
# ---------------------------------------------------------------------------

def _leaves(tree: Any) -> list:
    """Leaves in the reference's tree order (dicts by sorted key, tuples and
    named tuples in order); a :class:`Placement` is a leaf."""
    return tree_flatten(tree)[0]


def _shape_itemsize(leaf) -> Tuple[Tuple[int, ...], int]:
    """(shape, bytes per element) of a leaf; a Python int is an int32 scalar."""
    if isinstance(leaf, int) and not isinstance(leaf, bool):
        return (), 4
    dtype = leaf.dtype
    if isinstance(dtype, (str, torch.dtype)):
        size = torch_dtype(dtype).itemsize
    else:
        size = np.dtype(dtype).itemsize
    return tuple(leaf.shape), size


def _norm_index(idx: Tuple, shape: Tuple[int, ...]) -> Tuple[Tuple[int, int], ...]:
    """Normalize an ``indices_map`` entry to ((start, stop), ...) pairs."""
    out = []
    for sl, dim in zip(idx, shape):
        start, stop, step = sl.indices(dim)
        assert step == 1, "strided shards unsupported"
        out.append((start, stop))
    return tuple(out)


def _volume(norm: Tuple[Tuple[int, int], ...]) -> int:
    v = 1
    for start, stop in norm:
        v *= max(stop - start, 0)
    return v


def _overlap(a, b) -> int:
    v = 1
    for (a0, a1), (b0, b1) in zip(a, b):
        v *= max(min(a1, b1) - max(a0, b0), 0)
    return v


def _leaf_moved_bytes(leaf, old: Placement, new: Placement) -> int:
    """Bytes a migration must move for one leaf: every destination slot
    pays for the part of its new slice it does not already hold."""
    shape, itemsize = _shape_itemsize(leaf)
    if old == new:
        return 0
    old_map = {s: _norm_index(idx, shape) for s, idx in old.indices_map(shape).items()}
    moved = 0
    for slot, idx in new.indices_map(shape).items():
        need = _norm_index(idx, shape)
        have = old_map.get(slot)
        vol = _volume(need)
        if have is not None:
            vol -= _overlap(need, have)
        moved += max(vol, 0) * itemsize
    return moved


def reshard_bytes(tree: Any, old_shardings: Any, new_shardings: Any) -> int:
    """Bytes actually moved by resharding ``tree`` from ``old_shardings``
    to ``new_shardings`` (placement trees of the same structure) —
    leaf-by-leaf slice-overlap accounting, computable before committing to
    a migration. Compare with :func:`tree_bytes`."""
    leaves = _leaves(tree)
    old_leaves = _leaves(old_shardings)
    new_leaves = _leaves(new_shardings)
    assert len(leaves) == len(old_leaves) == len(new_leaves)
    return int(sum(_leaf_moved_bytes(leaf, old, new)
                   for leaf, old, new in zip(leaves, old_leaves, new_leaves)))


def leg_state_bytes(tree: Any, shardings: Any, plan: MeshPlan, leg_index: int) -> int:
    """Bytes that must cross the DCN to rebuild ONE lost allocation leg:
    the DISTINCT slices the leg's slots hold under ``shardings`` (each is
    sent once and fanned out over the leg's own interconnect). Legs are
    told apart by slot position, since a pool may repeat a device."""
    lo, hi = plan.leg_spans[leg_index]
    leg_slots = set(plan.mesh.slots[lo:hi])
    total = 0
    leaves = _leaves(tree)
    sh_leaves = _leaves(shardings)
    assert len(leaves) == len(sh_leaves)
    for leaf, sh in zip(leaves, sh_leaves):
        shape, itemsize = _shape_itemsize(leaf)
        seen = set()
        for slot, idx in sh.indices_map(shape).items():
            if slot not in leg_slots:
                continue
            norm = _norm_index(idx, shape)
            if norm not in seen:
                seen.add(norm)
                total += _volume(norm) * itemsize
    return int(total)


def tree_bytes(tree: Any) -> int:
    """Full byte size of a tree — what a checkpoint restore transfers."""
    total = 0
    for leaf in _leaves(tree):
        shape, itemsize = _shape_itemsize(leaf)
        total += int(np.prod(shape)) * itemsize
    return int(total)


def train_state_bytes(model) -> int:
    """Param + Adam moment footprint of a model's TrainState, in bytes:
    ``3 ×`` the param bytes (f32 master params plus the two Adam moments);
    scalars are negligible. The orchestrator matches this against an
    instance shape's ``memory_gb × device_count``."""
    return 3 * param_bytes(model.specs)


def serve_state_bytes(
    model, batch: int, seq_len: int, *, int8_cache: bool = False
) -> int:
    """Footprint of one INFERENCE replica, in bytes: params once plus the
    KV/decode cache at the configured batch and context length (no
    optimizer state, so strictly smaller than :func:`train_state_bytes`)."""
    cache = model.cache_specs(batch, seq_len, int8=int8_cache)
    return param_bytes(model.specs) + param_bytes(cache)

