"""Rule-based placement resolution: logical dims -> mesh axes (port of
``repro.dist.sharding``).

Every ``ParamSpec`` names its dims with *logical* axes (``"embed"``,
``"ffn"``, ``"vocab"``, ...; ``repro_torch.models.common.LOGICAL_AXES``).
A rule table per :class:`~repro_torch.config.base.ShardingLayout` preset
maps each logical dim to an ordered tuple of candidate mesh axes, and
:func:`resolve_pspec` turns one ``(shape, dim_names)`` pair into one axis
tuple per dim under the reference's fallback discipline:

* **divisibility** — a mesh axis (or joint axis tuple) is only used when
  its size divides the dim exactly; otherwise axes are dropped (left-first
  for joint tuples) until the remainder divides, down to ``()``
  (replicated);
* **one use per tensor** — a mesh axis appears at most once in a spec;
* **scan dims** — ``"layers"`` / ``"groups"`` are never sharded;
* **degenerate dims** — a dim of size 1 replicates.

Where JAX has a ``Mesh`` of devices and a ``NamedSharding``, the port has a
:class:`SlotMesh` — a grid of *slots*, each a place in a pool of torch
devices — and a :class:`Placement`. A pool may repeat one device (eight
slots on one card simulate an 8-device instance), so slots are told apart
by their index in the pool, never by the device object.
:meth:`Placement.indices_map` gives each slot its slice of a tensor, as
``NamedSharding.devices_indices_map`` gives each device its slice.
Placements decide the byte accounting (``repro_torch.dist.meshplan``).
Cache placements price the dense cache a serving migration moves
(:func:`cache_shardings`).

A mesh built over the ranks of a ``torch.distributed`` world
(``repro_torch.launch.mesh``) is ``distributed``: slot i is rank i, a
process of its own on ``devices[i]``, and a rank holds only its slice of
each tensor (:meth:`Placement.box`). There :func:`batch_shardings` gives
each rank its rows of the batch, :func:`rows_shardings` a serving rank its
rows of the cache at full length (what it computes on), and
``repro_torch.dist.elastic`` moves slices between ranks. Activation
shardings (``make_activation_constrainer``) need tensor-parallel compute,
which the port does not have: they are not ported.
"""
from __future__ import annotations

import dataclasses
import itertools
import math
from typing import Any, Dict, Optional, Sequence, Tuple, Union

import torch

from repro_torch.config.base import ShardingLayout
from repro_torch.models.common import LOGICAL_AXES, SCAN_AXES, tree_map

Rule = Dict[str, Tuple[str, ...]]


def _rule(**overrides: Tuple[str, ...]) -> Rule:
    """Baseline FSDP+TP rule set with per-logical-dim overrides."""
    base: Rule = {
        # embedding / residual width shards over the data axis (FSDP-style
        # parameter sharding: the gradient all-reduce doubles as the gather)
        "embed": ("data",),
        "enc_embed": ("data",),
        "vit_embed": ("model",),
        # big per-layer matmul dims shard over the model (TP) axis
        "vocab": ("model",),
        "q_dim": ("model",),
        "kv_dim": ("model",),
        "ffn": ("model",),
        "experts": ("model",),
        "ssm_inner": ("model",),
        "dt_rank": (),
        "ssm_state": (),
        "conv": (),
        # activation dims; 'pod' is the reference's multi-pod mesh axis: the
        # port builds no multi-pod mesh until it runs on more than one device,
        # and a rule naming an axis its mesh lacks resolves to no sharding
        "batch": ("pod", "data"),  # repro-lint: disable=S001
        "seq": ("model",),
        "heads": ("model",),
        "kv_heads": ("model",),
        "head_dim": (),
    }
    base.update(overrides)
    unknown = set(base) - set(LOGICAL_AXES)
    assert not unknown, f"rules name unknown logical dims: {unknown}"
    return base


PARAM_RULES: Dict[str, Rule] = {
    "baseline": _rule(),
    # pure tensor parallelism: params replicated across data shards
    "tp_only": _rule(embed=(), enc_embed=()),
    # shard everything possible over data first, joint data+model on ffn
    "fsdp_heavy": _rule(
        vocab=("data", "model"), ffn=("data", "model"), experts=()
    ),
    # tensor-parallel experts: replicate the expert dim, split each expert's
    # ffn over the model axis (all-reduce instead of all-to-all)
    "moe_tp": _rule(experts=(), ffn=("model",)),
}


@dataclasses.dataclass(frozen=True)
class SlotMesh:
    """The counterpart of ``jax.sharding.Mesh``: a row-major grid of slots.

    ``slots[i]`` is the pool index of the grid's i-th position and
    ``devices[i]`` the torch device that slot names. In a ``distributed``
    mesh the pool is the world: a slot is a rank, and its device lives in
    that rank's process."""

    grid_shape: Tuple[int, ...]
    axis_names: Tuple[str, ...]
    slots: Tuple[int, ...]
    devices: Tuple[torch.device, ...]
    distributed: bool = False

    def __post_init__(self):
        assert len(self.grid_shape) == len(self.axis_names)
        assert len(self.slots) == len(self.devices) == math.prod(self.grid_shape)

    @property
    def shape(self) -> Dict[str, int]:
        """Axis name -> size, as ``Mesh.shape``."""
        return dict(zip(self.axis_names, self.grid_shape))

    @property
    def distinct_devices(self) -> Tuple[torch.device, ...]:
        return tuple(dict.fromkeys(self.devices))


@dataclasses.dataclass(frozen=True)
class Placement:
    """The counterpart of ``NamedSharding``: a mesh and one tuple of mesh
    axes per tensor dim (``()`` replicates the dim)."""

    mesh: SlotMesh
    spec: Tuple[Tuple[str, ...], ...]

    def indices_map(self, shape: Sequence[int]) -> Dict[int, Tuple[slice, ...]]:
        """Slot -> the slice of a tensor of ``shape`` that it holds: a dim
        sharded over axes ``(a, b)`` splits into ``size(a) * size(b)``
        equal blocks, ``a`` major; a replicated dim is ``slice(None)``."""
        shape = tuple(shape)
        spec = self.spec or ((),) * len(shape)    # P(): every dim replicated
        assert len(shape) == len(spec), (shape, self.spec)
        sizes = self.mesh.shape
        names = self.mesh.axis_names
        out: Dict[int, Tuple[slice, ...]] = {}
        coords = itertools.product(*(range(n) for n in self.mesh.grid_shape))
        for slot, coord in zip(self.mesh.slots, coords):
            at = dict(zip(names, coord))
            idx = []
            for dim, axes in zip(shape, spec):
                if not axes:
                    idx.append(slice(None))
                    continue
                shard = 0
                for a in axes:
                    shard = shard * sizes[a] + at[a]
                block = dim // math.prod(sizes[a] for a in axes)
                idx.append(slice(shard * block, (shard + 1) * block))
            out[slot] = tuple(idx)
        return out

    def box(self, shape: Sequence[int], slot: int) -> Optional[Tuple[Tuple[int, int], ...]]:
        """The ((start, stop), ...) box of a tensor of ``shape`` that
        ``slot`` holds, or None where the slot is not in the mesh."""
        idx = self.indices_map(shape).get(slot)
        if idx is None:
            return None
        return tuple(sl.indices(dim)[:2] for sl, dim in zip(idx, tuple(shape)))


def _fit_axes(dim: int, candidates, sizes: Dict[str, int], used: set):
    """Keep only mesh axes not yet used by this tensor, then drop axes
    (outermost first) until the joint size divides the dim. Marks the
    surviving axes used and returns them as a (possibly empty) tuple."""
    axes = [a for a in candidates if a in sizes and a not in used]
    while axes and dim % math.prod(sizes[a] for a in axes):
        axes = axes[1:]
    used.update(axes)
    return tuple(axes)


def resolve_pspec(
    shape: Sequence[int],
    dim_names: Sequence[Optional[str]],
    rules: Rule,
    mesh: SlotMesh,
) -> Tuple[Tuple[str, ...], ...]:
    """Resolve one tensor's logical dims to one axis tuple per dim."""
    assert len(shape) == len(dim_names), (shape, dim_names)
    sizes = mesh.shape
    used: set = set()
    parts = []
    for dim, name in zip(shape, dim_names):
        if name is None or name in SCAN_AXES or dim <= 1:
            parts.append(())
            continue
        cand = rules.get(name, ())
        if isinstance(cand, str):
            cand = (cand,)
        parts.append(_fit_axes(dim, cand, sizes, used))
    return tuple(parts)


def _spec_shardings(specs: Any, mesh: SlotMesh, rules: Rule) -> Any:
    return tree_map(
        lambda s: Placement(mesh, resolve_pspec(s.shape, s.axes, rules, mesh)), specs)


def _rules_for(layout: Union[ShardingLayout, str, Rule], key: str = "param_rules") -> Rule:
    if isinstance(layout, dict):
        return layout
    if isinstance(layout, str):
        return PARAM_RULES[layout]
    name = getattr(layout, key, "") or layout.param_rules
    return PARAM_RULES[name]


def rank_mesh(rank: int, device: torch.device) -> SlotMesh:
    """A one-slot distributed mesh: the placement of a tree that one rank
    holds whole (a checkpoint's writer, a restore before its scatter)."""
    return SlotMesh(grid_shape=(1, 1), axis_names=("data", "model"), slots=(rank,),
                    devices=(torch.device(device),), distributed=True)


def replicated(mesh: SlotMesh) -> Placement:
    """The placement of a tensor every slot holds whole
    (``NamedSharding(mesh, P())``)."""
    return Placement(mesh, ())


def param_shardings(specs: Any, mesh: SlotMesh, layout: Union[ShardingLayout, str]) -> Any:
    """Placement tree (same structure as ``specs``) for the params."""
    return _spec_shardings(specs, mesh, _rules_for(layout))


def opt_state_shardings(specs: Any, mesh: SlotMesh, layout: ShardingLayout) -> Any:
    """Placements for one optimizer-moment tree (Adam m/v mirror the params).

    ``layout.opt_rules`` overrides the param rules — e.g. ZeRO-1 keeps
    params tp_only but moments fully sharded ("baseline").
    """
    return _spec_shardings(specs, mesh, _rules_for(layout, key="opt_rules"))


def cache_shardings(cache_specs: Any, mesh: SlotMesh, layout: ShardingLayout) -> Any:
    """Placements for the decode cache. Cache specs carry their own logical
    dims (``batch``/``seq``/``kv_heads``/...); the seq (slot) dim shards over
    the model axis — ``cache_len_for`` rounds it to a multiple of 16 so this
    always divides on the production mesh."""
    return _spec_shardings(cache_specs, mesh, _rules_for(layout))


def batch_shardings(inputs: Dict[str, Any], mesh: SlotMesh) -> Dict[str, Placement]:
    """Input-batch placements: the leading dim over the data axes, the rest
    replicated; a batch the data axes do not divide replicates (the
    divisibility fallback of :func:`resolve_pspec`). ``inputs`` maps names
    to anything with a ``.shape``."""
    rules = PARAM_RULES["baseline"]

    def one(x) -> Placement:
        names = ("batch",) + (None,) * (len(x.shape) - 1)
        return Placement(mesh, resolve_pspec(x.shape, names, rules, mesh))

    return {k: one(v) for k, v in inputs.items()}


def rows_shardings(specs: Any, mesh: SlotMesh) -> Any:
    """The "rows" placement of a tree of specs (a decode cache): the batch
    dim over the data axes as :func:`batch_shardings` places the inputs,
    every other dim replicated. A serving rank computes on the rows of its
    ``data`` coordinate at full sequence length, so this is where a cache
    lives while it is decoded; :func:`cache_shardings` is where it is held
    while it moves."""
    rules = PARAM_RULES["baseline"]
    return tree_map(lambda s: Placement(mesh, resolve_pspec(
        s.shape, tuple(a if a == "batch" else None for a in s.axes), rules, mesh)), specs)
