"""Checkpoint manager: async, atomic, keep-last-k (port of
``repro.ckpt.manager``).

Layout on disk (one directory per step), the reference's:

    <root>/step_<N>.tmp/            # written here first
        manifest.json               # step, shapes, dtypes
        arr_<i>.npy                 # one file per leaf
    <root>/step_<N>/                # atomic os.replace commit

Leaves are numbered in the reference's tree order (dict keys sorted,
named tuples and lists in order), and integer leaves (``count``,
``step``) are saved as int32 scalars, so a checkpoint written by one
package restores in the other. bf16 leaves are saved as their raw 16 bits
with dtype ``bfloat16`` in the manifest, which the reference reads back
as ``ml_dtypes.bfloat16``.

* **async** — ``save()`` copies the tensors to host memory and hands them to
  a background thread; the training loop never blocks on storage.
* **atomic** — readers only see fully-written checkpoints: the tmp
  directory is renamed into place (``os.replace``) after fsync.
* **keep-last-k** — the newest k commits survive.
* **restore** — onto a device, into the structure of a ``like`` tree.

In a ``torch.distributed`` world (``repro_torch.launch.mesh``) rank 0 is
the one writer: ``save`` with the state's ``shardings`` gathers every
slice to it over the plan's ranks (``dist.elastic.move_leaves``) and only
it writes; ``restore`` reads on rank 0, whose whole tree the caller then
scatters onto the next plan (``reshard_tree`` from
:func:`writer_shardings`); ``latest_step`` is rank 0's, broadcast, so all
ranks decide alike.
"""
from __future__ import annotations

import json
import os
import pathlib
import queue
import shutil
import threading
import time
from typing import Any, List, Optional, Tuple

import numpy as np
import torch

from repro_torch.models.common import tree_flatten


def _world():
    from repro_torch.launch.mesh import world

    return world()


def writer_shardings(like: Any) -> Any:
    """The placement tree of a tree that the writer (rank 0) holds whole."""
    from repro_torch.dist.sharding import rank_mesh, replicated

    w = _world()
    leaves, unflatten = tree_flatten(like)
    return unflatten([replicated(rank_mesh(0, w.devices[0]))] * len(leaves))


def _to_host(x: Any) -> np.ndarray:
    """A host copy of one leaf, never a view: the train step updates params
    and moments in place while the writer thread saves them."""
    if isinstance(x, torch.Tensor):
        x = x.detach().to("cpu", copy=True)
        if x.dtype == torch.bfloat16:
            return x.view(torch.int16).numpy().view(np.uint16)
        return x.numpy()
    if isinstance(x, (int, np.integer)) and not isinstance(x, bool):
        return np.asarray(x, np.int32)
    return np.asarray(x)


class CheckpointManager:
    def __init__(self, root: str, keep: int = 3):
        self.root = pathlib.Path(root)
        self.root.mkdir(parents=True, exist_ok=True)
        self.keep = keep
        self._q: "queue.Queue[Optional[Tuple[int, Any]]]" = queue.Queue(maxsize=2)
        self._errors: List[BaseException] = []
        self._thread = threading.Thread(target=self._worker, daemon=True)
        self._thread.start()

    # ------------------------------------------------------------------
    def save(self, step: int, tree: Any, block: bool = False, shardings: Any = None) -> None:
        """Snapshot to host memory now; write + commit in the background.
        ``shardings``: the distributed placements ``tree``'s slices are laid
        out by; every rank of their mesh calls ``save``, the slices are
        gathered to the writer, and only it writes."""
        if shardings is not None:
            from repro_torch.dist.elastic import move_leaves
            from repro_torch.launch.mesh import group_for

            placements = tree_flatten(shardings)[0]
            leaves, unflatten = tree_flatten(tree)
            whole, _ = move_leaves(leaves, placements,
                                   tree_flatten(writer_shardings(tree))[0],
                                   group=group_for(placements[0].mesh.slots))
            if _world().rank != 0:
                return
            tree = unflatten(whole)
        leaves, _ = tree_flatten(tree)
        dtypes = [str(x.dtype).replace("torch.", "") if isinstance(x, torch.Tensor)
                  else None for x in leaves]
        host = [_to_host(x) for x in leaves]
        self._q.put((int(step), [(a, d or str(a.dtype)) for a, d in zip(host, dtypes)]))
        if block:
            self.wait()

    def wait(self) -> None:
        self._q.join()
        if self._errors:
            raise self._errors[-1]

    def close(self) -> None:
        self.wait()
        self._q.put(None)
        self._thread.join(timeout=5.0)

    # ------------------------------------------------------------------
    def _worker(self) -> None:
        while True:
            item = self._q.get()
            if item is None:
                self._q.task_done()
                return
            step, leaves = item
            try:
                self._write(step, leaves)
                self._gc()
            except BaseException as e:  # surfaced on next wait()
                self._errors.append(e)
            finally:
                self._q.task_done()

    def _write(self, step: int, leaves: list) -> None:
        tmp = self.root / f"step_{step:010d}.tmp"
        final = self.root / f"step_{step:010d}"
        if tmp.exists():
            shutil.rmtree(tmp)
        tmp.mkdir(parents=True)
        manifest = {
            "step": step,
            "n_leaves": len(leaves),
            "leaves": [
                {"file": f"arr_{i}.npy", "shape": list(a.shape), "dtype": dtype}
                for i, (a, dtype) in enumerate(leaves)
            ],
            "written_at": time.time(),
        }
        for i, (a, _) in enumerate(leaves):
            np.save(tmp / f"arr_{i}.npy", a, allow_pickle=False)
        (tmp / "manifest.json").write_text(json.dumps(manifest))
        # fsync the directory entries before the atomic publish
        fd = os.open(tmp, os.O_RDONLY)
        try:
            os.fsync(fd)
        finally:
            os.close(fd)
        if final.exists():
            shutil.rmtree(final)
        os.replace(tmp, final)

    def _gc(self) -> None:
        steps = self.all_steps()
        for s in steps[: -self.keep]:
            shutil.rmtree(self.root / f"step_{s:010d}", ignore_errors=True)

    # ------------------------------------------------------------------
    def all_steps(self) -> List[int]:
        out = []
        for p in self.root.iterdir():
            if p.is_dir() and p.name.startswith("step_") and not p.name.endswith(".tmp"):
                if (p / "manifest.json").exists():
                    out.append(int(p.name.split("_")[1]))
        return sorted(out)

    def latest_step(self) -> Optional[int]:
        """The newest committed step; in a world rank 0's, broadcast (every
        rank calls it alike)."""
        w = _world()
        if w is None:
            steps = self.all_steps()
            return steps[-1] if steps else None
        import torch.distributed as dist

        box = [None]
        if w.rank == 0:
            steps = self.all_steps()
            box = [steps[-1] if steps else None]
        dist.broadcast_object_list(box, src=0)
        return box[0]

    def restore(
        self,
        step: Optional[int] = None,
        device=None,
        like: Any = None,
    ) -> Tuple[int, Any]:
        """Load a checkpoint. Leaves come back as numpy arrays, or, with
        ``device``, as tensors there (bf16 leaves as bf16 tensors). ``like``
        is a structure template (e.g. a ``TrainState``) to unflatten into;
        where its leaf is a Python int, the restored leaf is one too.
        Without ``like`` the leaf list is returned. In a world only rank 0
        reads; every other rank gets ``like``'s structure with ``None``
        leaves (it holds nothing until the scatter)."""
        w = _world()
        if w is not None and w.rank != 0 and like is not None:
            like_leaves, unflatten = tree_flatten(like)
            return step, unflatten([None] * len(like_leaves))
        if step is None:
            steps = self.all_steps()
            step = steps[-1] if steps else None
        if step is None:
            raise FileNotFoundError(f"no checkpoints under {self.root}")
        d = self.root / f"step_{step:010d}"
        manifest = json.loads((d / "manifest.json").read_text())
        leaves = []
        for rec in manifest["leaves"]:
            arr = np.load(d / rec["file"], allow_pickle=False)
            if device is not None:
                t = torch.from_numpy(arr.view(np.int16) if rec["dtype"] == "bfloat16" else arr)
                if rec["dtype"] == "bfloat16":
                    t = t.view(torch.bfloat16)
                arr = t.to(device)
            leaves.append(arr)
        if like is None:
            return step, leaves
        like_leaves, unflatten = tree_flatten(like)
        if len(like_leaves) != len(leaves):
            raise ValueError(f"checkpoint has {len(leaves)} leaves, template {len(like_leaves)}")
        leaves = [int(a) if isinstance(t, int) else a for a, t in zip(leaves, like_leaves)]
        return step, unflatten(leaves)
