"""Params-only migration of a revoked serving replica (port of
``repro.serve.migrate``: the analytic model copied, the live helpers over
``repro_torch.dist``).

A revoked TRAINING leg moves params + both Adam moments (the
``TrainState``); a revoked SERVING replica moves **params only** — there
is no optimizer state to carry, and the KV cache is a policy decision:

* ``cache_policy="drop"`` — the cache dies with the instance; in-flight
  requests re-prefill on the replacement, billed as **recompute time**
  (``re_execution``: it is re-execution of prefill work the fleet already
  did once);
* ``cache_policy="migrate"`` — the cache crosses the DCN next to the
  params, billed at DCN bandwidth like any other reshard bytes.

Either way the serving migration moves STRICTLY fewer bytes than the
training path would for the same revocation (opt state never moves) —
:func:`migration_cost` asserts it rather than assuming it, mirroring the
reshard-vs-restore byte discipline of the training orchestrator.

Two layers:

* the **analytic** model (:func:`migration_cost`) prices a migration from
  the model's spec trees alone — what the fleet simulator and
  ``benchmarks/serve_bench.py`` bill;
* the **live** helpers (:func:`replica_param_bytes_moved`,
  :func:`assert_params_only`, :func:`migrate_cache`) measure the bytes an
  actual cross-mesh reshard moves, for the real
  revocation→migration→serve round trip in
  ``repro_torch.launch.serve --plan``. A torch tensor carries no
  placement (the reference reads it with ``live_shardings``), so they
  take the tree's current placements from the caller.
"""
from __future__ import annotations

import dataclasses
from typing import Any, Optional

from repro_torch.core.units import BYTES_PER_GB, SECONDS_PER_HOUR

CACHE_POLICIES = ("drop", "migrate")


@dataclasses.dataclass(frozen=True)
class MigrationCost:
    """Priced migration of one serving replica onto a replacement shape."""

    params_bytes: int        # params crossing the DCN (always move)
    cache_bytes: int         # cache bytes moved (0 under "drop")
    recompute_hours: float   # re-prefill wall hours (0 under "migrate")
    wire_hours: float        # (params + cache) / DCN bandwidth
    train_path_bytes: int    # what the training path moves: params + opt
    restore_bytes: int       # full serving state through remote storage

    @property
    def moved_bytes(self) -> int:
        return self.params_bytes + self.cache_bytes

    @property
    def hours(self) -> float:
        return self.wire_hours + self.recompute_hours


def migration_cost(
    *,
    param_bytes: int,
    cache_bytes: int,
    cache_policy: str = "drop",
    dcn_gbps: float,
    inflight_context_tokens: float = 0.0,
    prefill_tokens_per_sec: float = 1.0,
) -> MigrationCost:
    """Price one replica migration analytically.

    ``param_bytes`` / ``cache_bytes`` come from the model's spec trees
    (``dist.meshplan.serve_state_bytes`` decomposition); the replacement
    replica starts empty, so the params cross the DCN once in full — from
    the surviving replicas, not from storage. Under ``drop`` the cache is
    rebuilt by re-prefilling ``inflight_context_tokens`` at the
    replacement's prefill rate. Asserts the params-only invariant:
    strictly fewer bytes than the training path (params + 2 Adam moments)
    for the same revocation.
    """
    assert cache_policy in CACHE_POLICIES, cache_policy
    assert param_bytes > 0
    train_path = 3 * param_bytes  # fp32 master + Adam m, v — never moves here
    moved_cache = int(cache_bytes) if cache_policy == "migrate" else 0
    moved = param_bytes + moved_cache
    # the params-only invariant: the STATE the training path would restore
    # (params + both Adam moments) strictly dominates the serving params
    # leg. The cache is a separate, policy-priced quantity — a huge-batch
    # cache under "migrate" may legitimately exceed it and is billed for
    # what it is, not asserted away.
    assert param_bytes < train_path, (param_bytes, train_path)
    wire_hours = moved / (max(dcn_gbps, 1e-9) * BYTES_PER_GB) / SECONDS_PER_HOUR
    recompute_hours = 0.0
    if cache_policy == "drop" and inflight_context_tokens > 0:
        recompute_hours = (
            inflight_context_tokens / max(prefill_tokens_per_sec, 1e-9) / SECONDS_PER_HOUR
        )
    return MigrationCost(
        params_bytes=int(param_bytes),
        cache_bytes=moved_cache,
        recompute_hours=recompute_hours,
        wire_hours=wire_hours,
        train_path_bytes=train_path,
        restore_bytes=int(param_bytes) + int(cache_bytes),
    )


# ---------------------------------------------------------------------------
# Live helpers (real tensors, slot meshes) — used by launch/serve.py --plan
# ---------------------------------------------------------------------------

def replica_param_bytes_moved(params: Any, old_shardings: Any, new_shardings: Any) -> int:
    """Bytes a live params-only migration of ``params`` (placed as
    ``old_shardings``) moves onto ``new_shardings`` — the exact
    slice-overlap arithmetic the training orchestrator uses, applied to
    the param tree alone."""
    from repro_torch.dist.meshplan import reshard_bytes

    return reshard_bytes(params, old_shardings, new_shardings)


def assert_params_only(params_moved: int, model) -> int:
    """The params-only invariant on LIVE bytes: a serving migration moved
    fewer bytes than the same model's TrainState restore would. Returns
    the training-path byte count for reporting."""
    from repro_torch.dist.meshplan import train_state_bytes

    train_path = train_state_bytes(model)
    assert params_moved < train_path, (params_moved, train_path)
    return train_path


def migrate_cache(
    cache: Any,
    new_shardings: Any,
    cache_policy: str,
    old: Any = None,
) -> Optional[Any]:
    """Apply the cache policy to a live cache: move it onto the new
    placements (``migrate``) or drop it (``drop`` — caller re-prefills).

    Over the ranks of a world (distributed placements) ``cache`` is this
    rank's slices laid out by ``old`` (None where it holds none) and they
    move by ``reshard_tree``: each rank of the new placements receives
    exactly its share of ``reshard_bytes(cache, old, new_shardings)``.
    In one process the moved cache is a fresh copy on the placements'
    device, so the replacement shares no storage with the dying replica's
    cache, even when both name the same device (decode writes the cache in
    place)."""
    assert cache_policy in CACHE_POLICIES, cache_policy
    if cache_policy == "drop":
        return None
    from repro_torch.dist.elastic import placement_device, reshard_tree
    from repro_torch.models.common import tree_flatten

    if any(p.mesh.distributed for p in tree_flatten(new_shardings)[0]):
        return reshard_tree(cache, new_shardings, old)

    leaves, unflatten = tree_flatten(cache)
    placements = tree_flatten(new_shardings)[0]
    assert len(leaves) == len(placements), (len(leaves), len(placements))
    return unflatten([x.to(placement_device(p), copy=True)
                      for x, p in zip(leaves, placements)])
