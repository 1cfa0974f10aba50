"""Meshes over the ranks of a ``torch.distributed`` world (port of
``repro.launch.mesh``), and the world's set-up and tear-down.

One process is one rank and one device, as the reference's pool is one
device per mesh position: NCCL on ``cuda:<rank>`` (one host, so the rank
is the local rank), or gloo on the CPU when the caller asks for the CPU.
A mesh built here is a :class:`~repro_torch.dist.sharding.SlotMesh` whose
slots are ranks ``0 .. n-1`` (``distributed=True``); each plan's ranks get
one process group (:func:`group_for`), made when the plan is made.
``torch.distributed.new_group`` must be called by EVERY rank of the world
in the same order, those outside the group included: build meshes and
plans from host logic that every rank runs alike.

Nothing here falls back: a world larger than the cards present raises, as
:func:`make_production_mesh` does for a world smaller than its grid
(``jax.make_mesh`` raises there too). The v5e constants of the reference's
file stay out: ``launch/roofline.py`` has the H100's.
"""
from __future__ import annotations

import dataclasses
import math
import pickle
import tempfile
import time
from pathlib import Path
from typing import Any, Callable, Dict, Optional, Sequence, Tuple

import torch
import torch.distributed as dist

from repro_torch import resolve_device
from repro_torch.dist.sharding import SlotMesh


@dataclasses.dataclass(frozen=True)
class World:
    """This process's place in the world: its rank, the world's size, the
    backend and every rank's device (``devices[rank]`` is its own)."""

    rank: int
    size: int
    backend: str
    devices: Tuple[torch.device, ...]

    @property
    def device(self) -> torch.device:
        return self.devices[self.rank]


_WORLD: Optional[World] = None
_GROUPS: Dict[Tuple[int, ...], Any] = {}


def init_world(rank: int, world_size: int, init_method: str, device="cuda") -> World:
    """Join the world as ``rank``: NCCL on ``cuda:rank``, or gloo when
    ``device`` is the CPU. Raises where fewer cards than ranks exist."""
    global _WORLD
    dev = resolve_device(device)
    if dev.type == "cuda":
        if torch.cuda.device_count() < world_size:
            raise RuntimeError(f"a world of {world_size} ranks needs {world_size} cards, "
                               f"{torch.cuda.device_count()} present")
        devices = tuple(torch.device("cuda", r) for r in range(world_size))
        torch.cuda.set_device(devices[rank])
        backend = "nccl"
    else:
        devices = (torch.device("cpu"),) * world_size
        backend = "gloo"
    dist.init_process_group(backend, init_method=init_method, rank=rank,
                            world_size=world_size)
    _WORLD = World(rank=rank, size=world_size, backend=backend, devices=devices)
    return _WORLD


def world() -> Optional[World]:
    """The world this process joined, or None."""
    return _WORLD


def shutdown_world() -> None:
    global _WORLD
    if _WORLD is not None and dist.is_initialized():
        dist.destroy_process_group()
    _GROUPS.clear()
    _WORLD = None


def group_for(ranks: Sequence[int]):
    """The process group of ``ranks`` (the whole world's for all of them),
    made at the first call and cached. Every rank must make the same calls
    in the same order: a rank outside ``ranks`` gets a handle it must not
    use."""
    ranks = tuple(ranks)
    w = _WORLD
    if w is None:
        raise RuntimeError("no world: call init_world first")
    if ranks == tuple(range(w.size)):
        return dist.group.WORLD
    if ranks not in _GROUPS:
        _GROUPS[ranks] = dist.new_group(list(ranks))
    return _GROUPS[ranks]


def world_mesh(shape: Sequence[int], axes: Sequence[str]) -> SlotMesh:
    """A mesh over ranks ``0 .. prod(shape)-1`` of the world, its process
    group made (every rank calls this alike)."""
    w = _WORLD
    n = math.prod(shape)
    if w is None:
        raise RuntimeError("no world: call init_world first")
    if n > w.size:
        raise ValueError(f"a {tuple(shape)} mesh needs {n} ranks; the world has {w.size}")
    mesh = SlotMesh(grid_shape=tuple(shape), axis_names=tuple(axes), slots=tuple(range(n)),
                    devices=w.devices[:n], distributed=True)
    group_for(mesh.slots)
    return mesh


def make_mesh(shape: Sequence[int], axes: Sequence[str], device="cuda") -> SlotMesh:
    """Arbitrary mesh (elastic re-meshing, tests): over the world's ranks,
    or, with no world, one slot on ``device``."""
    if _WORLD is not None:
        return world_mesh(shape, axes)
    if math.prod(shape) != 1:
        raise ValueError(f"a {tuple(shape)} mesh needs a world of {math.prod(shape)} ranks "
                         f"(init_world); this process is one")
    return SlotMesh(grid_shape=tuple(shape), axis_names=tuple(axes), slots=(0,),
                    devices=(resolve_device(device),))


def make_host_mesh(model_parallel: int = 1, device="cuda") -> SlotMesh:
    """Mesh over every rank of the world (or this process's one device):
    (n / model_parallel, model_parallel) over ("data", "model")."""
    n = _WORLD.size if _WORLD is not None else 1
    if model_parallel < 1 or n % model_parallel:
        raise ValueError(f"a model axis of {model_parallel} does not divide {n} rank(s)")
    return make_mesh((n // model_parallel, model_parallel), ("data", "model"), device)


def make_production_mesh(*, multi_pod: bool = False) -> SlotMesh:
    """The reference's production grid, 16 x 16 (x 2 pods over ``pod``),
    over the world's ranks; raises when the world is smaller."""
    shape = (2, 16, 16) if multi_pod else (16, 16)
    axes = ("pod", "data", "model") if multi_pod else ("data", "model")
    size = _WORLD.size if _WORLD is not None else 1
    if size < math.prod(shape):
        raise ValueError(f"the production mesh {shape} needs {math.prod(shape)} ranks; "
                         f"the world has {size}")
    return world_mesh(shape, axes)


# ---------------------------------------------------------------------------
# Spawning a world on one host
# ---------------------------------------------------------------------------

def _rank_main(rank: int, fn: Callable, world_size: int, device: str, init_method: str,
               tmp: str, threads: int) -> None:
    if threads:
        torch.set_num_threads(threads)
    with open(Path(tmp) / "args.pkl", "rb") as f:
        args = pickle.load(f)
    w = init_world(rank, world_size, init_method, device)
    try:
        result = fn(w, *args)
        if rank == 0:
            with open(Path(tmp) / "result.pkl", "wb") as f:
                pickle.dump(result, f)
    finally:
        shutdown_world()


def run_world(fn: Callable, world_size: int, device="cuda", args: tuple = (), *,
              timeout: Optional[float] = 600.0, init_method: Optional[str] = None,
              threads: int = 0) -> Any:
    """Run ``fn(world, *args)`` in ``world_size`` spawned ranks on this
    host and return rank 0's result. ``fn`` must be importable by name.
    ``init_method`` defaults to a file store in a fresh temporary
    directory; ``threads`` sets each rank's intra-op threads (0: torch's
    default). Every rank is killed if the world has not ended within
    ``timeout`` seconds (None: no limit), and a rank that fails fails the
    call."""
    import torch.multiprocessing as mp

    with tempfile.TemporaryDirectory() as tmp:
        method = init_method or f"file://{Path(tmp) / 'store'}"
        # the arguments go through a file: a spawned rank reads its pipe only
        # once it has imported, so large arguments in the pipe would start
        # the ranks one after another
        with open(Path(tmp) / "args.pkl", "wb") as f:
            pickle.dump(tuple(args), f)
        ctx = mp.start_processes(
            _rank_main, args=(fn, world_size, str(device), method, tmp, threads),
            nprocs=world_size, join=False, start_method="spawn")
        deadline = time.monotonic() + (timeout if timeout is not None else float("inf"))
        try:
            while not ctx.join(timeout=None if timeout is None
                               else max(deadline - time.monotonic(), 0.0)):
                if time.monotonic() >= deadline:
                    raise TimeoutError(f"a world of {world_size} did not end in {timeout} s")
        finally:
            for p in ctx.processes:
                if p.is_alive():
                    p.kill()
                    p.join()
        with open(Path(tmp) / "result.pkl", "rb") as f:
            return pickle.load(f)


def local_world_size(device="cuda") -> int:
    """Every local card, as ``make_host_mesh()`` takes every local device;
    on the CPU one rank. Raises where CUDA is asked for but absent."""
    dev = resolve_device(device)
    return torch.cuda.device_count() if dev.type == "cuda" else 1

