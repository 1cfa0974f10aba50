"""Elastic resharding: move live training state between placements (port
of ``repro.dist.elastic``).

The reference ``device_put``s every leaf onto its new ``NamedSharding``
and lets the runtime issue the copies. Here two kinds of placement exist:

* a pool of slots in ONE process (eight slots on one card simulate an
  8-device instance): a leaf moves to the one device its placement's
  slots name (``.to``, no copy when it is already there); a placement
  over more than one distinct device raises;
* a ``distributed`` placement over the ranks of a ``torch.distributed``
  world (``repro_torch.launch.mesh``): each rank holds its slice of each
  leaf (``None`` where it holds nothing). :func:`reshard_tree` then gives
  every rank of the new placement exactly the part of its new slice that
  it does not already hold, each piece from one deterministic source (the
  lowest rank that holds it), in one ``all_to_all_single`` of bytes a
  leaf. What a rank receives is what ``meshplan.reshard_bytes`` prices for
  its slot, so the bytes received, summed over ranks, equal that count
  (``stats`` keeps this rank's). Python ints (``step``, ``count``) travel
  as int32 scalars, as the byte count counts them.

Every collective here is called by every rank of the group it names, in
the same order: the leaves, placements and pieces are worked out alike on
every rank from the placements alone (a rank holding ``None`` learns the
leaves' shapes and dtypes from the lowest rank of the old placement).
"""
from __future__ import annotations

import dataclasses
import itertools
import math
from typing import Any, Dict, List, Optional, Sequence, Tuple

import torch
import torch.distributed as dist

from repro_torch.config.base import ShardingLayout
from repro_torch.dist.sharding import Placement, SlotMesh, param_shardings, replicated
from repro_torch.models.common import tree_flatten

Box = Tuple[Tuple[int, int], ...]


@dataclasses.dataclass
class MoveStats:
    """The bytes this rank received in the world's reshards."""

    bytes_received: int = 0


stats = MoveStats()


def _world():
    from repro_torch.launch.mesh import world

    w = world()
    if w is None:
        raise RuntimeError("a distributed placement needs a world (launch.mesh.init_world)")
    return w


def placement_device(placement: Placement) -> torch.device:
    """The device a placement's slots name for this process: its own
    rank's for a distributed placement, else the pool's one device."""
    if placement.mesh.distributed:
        return _world().device
    devices = placement.mesh.distinct_devices
    if len(devices) != 1:
        raise NotImplementedError(
            f"repro_torch: a placement over {len(devices)} distinct devices "
            f"({', '.join(map(str, devices))}) in one process; a pool spanning devices is a "
            f"world of ranks (launch.mesh)")
    return devices[0]


def _put(x, placement: Placement):
    dev = placement_device(placement)
    return x.to(dev) if isinstance(x, torch.Tensor) else x


# ---------------------------------------------------------------------------
# Boxes and pieces
# ---------------------------------------------------------------------------

def _boxes(p: Placement, shape) -> Dict[int, Box]:
    return {s: tuple(sl.indices(d)[:2] for sl, d in zip(idx, shape))
            for s, idx in p.indices_map(shape).items()}


def _volume(b: Box) -> int:
    return math.prod(hi - lo for lo, hi in b)


def _meet(a: Box, b: Box) -> Optional[Box]:
    out = tuple((max(a0, b0), min(a1, b1)) for (a0, a1), (b0, b1) in zip(a, b))
    return out if all(lo < hi for lo, hi in out) else None


def _within(t: torch.Tensor, outer: Box, inner: Box) -> torch.Tensor:
    """The part ``inner`` of a tensor that holds the box ``outer``."""
    return t[tuple(slice(i0 - o0, i1 - o0) for (o0, _), (i0, i1) in zip(outer, inner))]


def _holders(boxes: Dict[int, Box]) -> Dict[Box, List[int]]:
    """Distinct box -> the slots holding it, lowest first (boxes of one
    placement are equal or disjoint)."""
    out: Dict[Box, List[int]] = {}
    for s in sorted(boxes):
        out.setdefault(boxes[s], []).append(s)
    return out


def _as_tensor(x, device) -> Optional[torch.Tensor]:
    if x is None or isinstance(x, torch.Tensor):
        return x
    return torch.tensor(int(x), dtype=torch.int32, device=device)


def _leaf_meta(x, p: Placement) -> Tuple[Tuple[int, ...], str]:
    """(global shape, dtype name) of a held slice ("int" for a Python int)."""
    if not isinstance(x, torch.Tensor):
        return (), "int"
    spec = p.spec or ((),) * x.dim()
    sizes = p.mesh.shape
    shape = tuple(n * math.prod(sizes[a] for a in axes) for n, axes in zip(x.shape, spec))
    return shape, str(x.dtype).replace("torch.", "")


def _dtype(name: str) -> torch.dtype:
    return torch.int32 if name == "int" else getattr(torch, name)


def _group_ranks(group) -> List[int]:
    return sorted(dist.get_process_group_ranks(group))


def _metas(leaves, old: Sequence[Placement], group, ranks: List[int]) -> list:
    """Every leaf's (global shape, dtype) on every rank of ``group``: from
    the held slices where every member holds one, else broadcast by the
    old placement's lowest slot."""
    mesh = old[0].mesh if old else None
    if all(set(ranks) <= set(p.mesh.slots) for p in old):
        return [_leaf_meta(x, p) for x, p in zip(leaves, old)]
    src = min(mesh.slots)
    box = [[_leaf_meta(x, p) for x, p in zip(leaves, old)] if _world().rank == src else None]
    dist.broadcast_object_list(box, src=src, group=group)
    return box[0]


def _exchange(moves: List[Tuple[int, int, Box]], outgoing: Dict[int, torch.Tensor],
              dtype: torch.dtype, group, ranks: List[int], device) -> Dict[int, torch.Tensor]:
    """One ``all_to_all_single`` of bytes over ``group``: for each move
    (src, dst, box) this rank sends ``outgoing[i]`` where it is src and
    receives a tensor of the box's shape where it is dst. Pieces between
    two ranks go in the order of ``moves``."""
    me = _world().rank
    pos = {r: i for i, r in enumerate(ranks)}
    item = torch.empty((), dtype=dtype).element_size()
    send: List[List[torch.Tensor]] = [[] for _ in ranks]
    send_sizes, recv_sizes = [0] * len(ranks), [0] * len(ranks)
    for i, (s, d, b) in enumerate(moves):
        n = _volume(b) * item
        if s == me:
            send[pos[d]].append(outgoing[i].contiguous().reshape(-1).view(torch.uint8))
            send_sizes[pos[d]] += n
        if d == me:
            recv_sizes[pos[s]] += n
    flat = [t for per in send for t in per]
    inp = torch.cat(flat) if flat else torch.empty(0, dtype=torch.uint8, device=device)
    out = torch.empty(sum(recv_sizes), dtype=torch.uint8, device=device)
    dist.all_to_all_single(out, inp, recv_sizes, send_sizes, group=group)
    starts = list(itertools.accumulate([0] + recv_sizes[:-1]))
    got: Dict[int, torch.Tensor] = {}
    for i, (s, d, b) in enumerate(moves):
        if d == me:
            n = _volume(b) * item
            a = starts[pos[s]]
            got[i] = out[a:a + n].view(dtype).reshape(tuple(hi - lo for lo, hi in b))
            starts[pos[s]] = a + n
    return got


def _release(x) -> None:
    if isinstance(x, torch.Tensor):
        x.set_()


def _back(t: Optional[torch.Tensor], like) -> Any:
    """A received int32 scalar back to a Python int where the leaf is one."""
    if t is None or like != "int":
        return t
    return int(t.item())


def move_leaves(leaves: list, old: Sequence[Placement], new: Sequence[Placement], *,
                group=None, release: bool = False) -> Tuple[list, int]:
    """This rank's new slices of ``leaves`` (its slices under ``old``, or
    None) under ``new``, and the bytes it received. Every rank of
    ``group`` (default: the world) calls it alike. With ``release`` a
    slice that is not kept is freed as its leaf moves (``set_()``), so a
    move needs a leaf of headroom, not a second tree."""
    w = _world()
    group = group if group is not None else dist.group.WORLD
    ranks = _group_ranks(group)
    me = w.rank
    metas = _metas(leaves, old, group, ranks)
    out, received = [], 0
    for x, p_old, p_new, (shape, dname) in zip(leaves, old, new, metas):
        dtype = _dtype(dname)
        x = _as_tensor(x, w.device)
        have_map, need_map = _boxes(p_old, shape), _boxes(p_new, shape)
        holders = _holders(have_map)
        moves: List[Tuple[int, int, Box]] = []
        for dst in sorted(need_map):
            need, have = need_map[dst], have_map.get(dst)
            for b, who in sorted(holders.items()):
                piece = _meet(b, need) if b != have else None
                if piece is not None:
                    moves.append((who[0], dst, piece))
        mine_old, mine_new = have_map.get(me), need_map.get(me)
        outgoing = {i: _within(x, mine_old, b) for i, (s, _, b) in enumerate(moves) if s == me}
        got = _exchange(moves, outgoing, dtype, group, ranks, w.device) if moves else {}
        if mine_new is None:
            y = None
        elif mine_old == mine_new:
            y = x
        else:
            y = torch.empty(tuple(hi - lo for lo, hi in mine_new), dtype=dtype, device=w.device)
            if mine_old is not None and _meet(mine_old, mine_new) is not None:
                keep = _meet(mine_old, mine_new)
                _within(y, mine_new, keep).copy_(_within(x, mine_old, keep))
            for i, t in got.items():
                _within(y, mine_new, moves[i][2]).copy_(t)
                received += t.numel() * t.element_size()
        if release and y is not x:
            _release(x)
        out.append(_back(y, dname))
    return out, received


def reshard_tree(tree: Any, shardings: Any, old: Any = None, *, group=None,
                 release: bool = True) -> Any:
    """Move every leaf of ``tree`` onto the matching placement of
    ``shardings``. On a pool in one process each tensor goes to its
    placement's device (other leaves pass). On distributed placements
    ``old`` is the placement tree the live slices are laid out by; the
    slices move between ranks, the old ones are freed as they go (unless
    ``release`` is False: a slice may share storage with a tree the caller
    keeps), and ``stats`` counts the bytes this rank received."""
    leaves, unflatten = tree_flatten(tree)
    placements = tree_flatten(shardings)[0]
    assert len(leaves) == len(placements), (len(leaves), len(placements))
    if not any(p.mesh.distributed for p in placements):
        return unflatten([_put(x, p) for x, p in zip(leaves, placements)])
    if old is None:
        raise ValueError("reshard_tree onto ranks needs the placements the slices hold (old)")
    old_leaves = tree_flatten(old)[0]
    assert len(old_leaves) == len(leaves), (len(old_leaves), len(leaves))
    moved, received = move_leaves(leaves, old_leaves, placements, group=group, release=release)
    stats.bytes_received += received
    return unflatten(moved)


def narrow_tree(tree: Any, held: Any, to: Any) -> Any:
    """Views of this rank's slices of ``tree`` (laid out by the placement
    tree ``held``) cut to its boxes under ``to``: no byte moves. Each box
    under ``to`` must lie inside the one held (a serving rank's rows of
    the cache narrowed to its ``cache_shardings`` slice); a leaf this rank
    holds nothing of under ``to`` is None."""
    me = _world().rank
    leaves, unflatten = tree_flatten(tree)
    out = []
    for x, p, q in zip(leaves, tree_flatten(held)[0], tree_flatten(to)[0]):
        shape, _ = _leaf_meta(x, p)
        outer, inner = _boxes(p, shape).get(me), _boxes(q, shape).get(me)
        if inner is None:
            out.append(None)
            continue
        if not isinstance(x, torch.Tensor):          # a Python int is whole
            out.append(x)
            continue
        if outer is None or _meet(outer, inner) != inner:
            raise ValueError(f"rank {me}: the box {inner} of a {shape} leaf is not inside "
                             f"the held box {outer}")
        out.append(_within(x, outer, inner))
    return unflatten(out)


def gather_tree(tree: Any, held: Any, to: Any, group) -> Tuple[Any, int]:
    """This rank's slices of ``tree`` under ``to`` (a plan's compute
    placement: the params replicated, the cache's rows) from its slices
    under ``held``, within the plan's process ``group`` (its ranks call
    this alike). A leaf this rank already holds as ``to`` lays it out is
    returned as it is, with no copy, so a plan of one rank costs nothing;
    the held slices are kept (a revocation moves them). Returns the tree
    and the bytes this rank received."""
    leaves, unflatten = tree_flatten(tree)
    moved, received = move_leaves(leaves, tree_flatten(held)[0], tree_flatten(to)[0],
                                  group=group)
    return unflatten(moved), received


def everywhere(tree: Any) -> Any:
    """The placement tree of a tree that every rank of the world holds
    whole (a fresh state each rank made from one seed)."""
    from repro_torch.launch.mesh import world_mesh

    leaves, unflatten = tree_flatten(tree)
    mesh = world_mesh((_world().size, 1), ("data", "model"))
    return unflatten([replicated(mesh)] * len(leaves))


def replicate(tree: Any, mesh: SlotMesh, old: Any = None) -> Any:
    """Fully replicate a tree across every slot of ``mesh``."""
    leaves, unflatten = tree_flatten(tree)
    return reshard_tree(tree, unflatten([replicated(mesh)] * len(leaves)), old)


def reshard_params(params: Any, specs: Any, mesh: SlotMesh, layout: ShardingLayout,
                   old: Any = None) -> Any:
    """Re-resolve the param placements on a NEW mesh and move the live
    params there (the elastic shrink/grow path): the divisibility
    fallbacks may pick other specs than on the old mesh."""
    return reshard_tree(params, param_shardings(specs, mesh, layout), old)


# ---------------------------------------------------------------------------
# A lost allocation leg, rebuilt
# ---------------------------------------------------------------------------

def rebuild_legs(leaves: list, shardings: Sequence[Placement], spans: Sequence[Tuple[int, int]],
                 slots: Sequence[int]) -> Tuple[list, Dict[str, int]]:
    """Rebuild the allocation legs whose slot spans are ``spans`` (positions
    in ``slots``, the plan's ranks) after their instances were lost, for
    the whole world (every rank calls it). Each distinct slice the lost
    ranks held is evacuated once to the lowest surviving rank, the lost
    ranks drop their slices, and the slice comes back once to the lowest
    new-leg rank that holds it (the bytes ``leg_state_bytes`` prices over
    the DCN), which hands it on to the leg's other holders. Returns the
    new leaves and this rank's bytes received at each stage
    (``evacuated``, ``rebuilt``, ``fanned_out``)."""
    w = _world()
    group = dist.group.WORLD
    ranks = _group_ranks(group)
    lost = sorted({slots[i] for lo, hi in spans for i in range(lo, hi)})
    survivors = [s for s in slots if s not in lost]
    got_bytes = {"evacuated": 0, "rebuilt": 0, "fanned_out": 0}
    if not lost or not survivors:
        return list(leaves), got_bytes
    keeper = survivors[0]
    metas = _metas(leaves, shardings, group, ranks)
    out = []
    for x, p, (shape, dname) in zip(leaves, shardings, metas):
        dtype = _dtype(dname)
        x = _as_tensor(x, w.device)
        boxes = _boxes(p, shape)
        held = _holders({s: b for s, b in boxes.items() if s in lost})
        order = sorted(held.items())
        evac = [(who[0], keeper, b) for b, who in order]
        got = _exchange(evac, {i: x for i, (s, _, _) in enumerate(evac) if s == w.rank},
                        dtype, group, ranks, w.device)
        kept = {evac[i][2]: t.clone() for i, t in got.items()}
        got_bytes["evacuated"] += sum(t.numel() * t.element_size() for t in kept.values())
        if w.rank in lost:
            _release(x)
            x = torch.empty(tuple(hi - lo for lo, hi in boxes[w.rank]), dtype=dtype,
                            device=w.device)
        back = [(keeper, who[0], b) for b, who in order]
        got = _exchange(back, {i: kept[b] for i, (s, _, b) in enumerate(back) if s == w.rank},
                        dtype, group, ranks, w.device)
        for t in got.values():
            x.copy_(t)
            got_bytes["rebuilt"] += t.numel() * t.element_size()
        fan = [(who[0], r, b) for b, who in order for r in who[1:]]
        got = _exchange(fan, {i: x for i, (s, _, _) in enumerate(fan) if s == w.rank},
                        dtype, group, ranks, w.device) if fan else {}
        for t in got.values():
            x.copy_(t)
            got_bytes["fanned_out"] += t.numel() * t.element_size()
        out.append(_back(x, dname))
    return out, got_bytes


# ---------------------------------------------------------------------------
# The collectives of a step on ranks
# ---------------------------------------------------------------------------

def _coords(mesh: SlotMesh) -> Dict[int, Dict[str, int]]:
    grid = itertools.product(*(range(n) for n in mesh.grid_shape))
    return {s: dict(zip(mesh.axis_names, c)) for s, c in zip(mesh.slots, grid)}


def reduce_over_data(full: torch.Tensor, placement: Placement, group) -> torch.Tensor:
    """This rank's slice of the sum of ``full`` over the ``data`` axis: each
    rank of the plan holds a whole tensor (a gradient over its own rows);
    each gets its slice from every rank of its column of the mesh (the
    ranks that differ from it in the ``data`` coordinate only), summed in
    rank order, so every run and every holder of a slice gives the same
    bits. One ``all_to_all_single`` over the plan's ``group``."""
    me = _world().rank
    mesh = placement.mesh
    shape = tuple(full.shape)
    boxes, at = _boxes(placement, shape), _coords(mesh)
    column = lambda r: [s for s in mesh.slots
                        if all(at[s][a] == at[r][a] for a in mesh.axis_names if a != "data")]
    moves = [(s, d, boxes[d]) for s in mesh.slots for d in column(s)]
    whole = tuple((0, n) for n in shape)
    got = _exchange(moves, {i: _within(full, whole, b) for i, (s, _, b) in enumerate(moves)
                            if s == me}, full.dtype, group, _group_ranks(group), full.device)
    parts = [got[i] for i in sorted(got, key=lambda i: moves[i][0])]
    out = parts[0].clone()
    for t in parts[1:]:
        out.add_(t)
    return out


def gather_rows(vec: torch.Tensor, group) -> torch.Tensor:
    """(ranks of ``group``, n): every rank's 1-D ``vec``, in rank order."""
    rows = [torch.empty_like(vec) for _ in _group_ranks(group)]
    dist.all_gather(rows, vec.contiguous(), group=group)
    return torch.stack(rows)


def first_holder(placement: Placement, shape) -> bool:
    """Whether this rank is the lowest slot holding its slice of a tensor
    of ``shape`` (so a sum over distinct slices counts each once)."""
    me = _world().rank
    boxes = _boxes(placement, tuple(shape))
    return me in boxes and _holders(boxes)[boxes[me]][0] == me


def data_leaders(mesh: SlotMesh) -> List[int]:
    """The lowest rank of each ``data`` coordinate of ``mesh``, in order."""
    at = _coords(mesh)
    return [s for s in mesh.slots if all(at[s][a] == 0 for a in mesh.axis_names if a != "data")]
