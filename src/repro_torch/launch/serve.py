"""Serving launcher of the port: lock-step batched prefill + greedy decode,
and serving on mesh plans through a spot revocation.

    python -m repro_torch.launch.serve --arch <id> [--batch 4] [--prompt-len 64]
        [--new-tokens 8] [--reduced | --no-reduced] [--device cuda|cpu] [--seed 0]
        [--devices N] [--model-parallel M] [--int8-cache] [--trace PATH]

Every mode runs over ``--devices`` ranks, one process and one device each
(by default every local card; one on the CPU): ``cuda`` with NCCL unless
``--device cpu``, which spawns N gloo ranks; it never falls back to the CPU
when the cards are missing, and a rank that fails fails the call. Rank 0
prints and writes the trace.

The host path is the counterpart of ``repro.launch.serve::host_main``
(``cuda`` unless ``--device cpu``); over ranks each ``data`` coordinate of
the ``make_host_mesh(--model-parallel)`` mesh serves its rows with the
whole params (made alike on every rank from the seed), and rank 0 gathers
them. On each device: one batched prefill over
the prompts, then ``new_tokens - 1`` greedy ``decode_step`` calls against
the dense cache (or, for xLSTM, the recurrent states), every row at the
same position. Attention prefills through the flash kernel's entry point,
hybrid blocks scan through the selective-scan kernel's and mLSTM blocks
through the chunkwise mLSTM kernel's, in prefill and in every decode
step: the CUDA kernels on the card, their plain versions on the CPU.
``--reduced`` (the default, as in the reference) serves the
family-preserving tiny config, ``--no-reduced`` the full one: for example
``--arch xlstm-350m --device cpu`` serves reduced xLSTM on the CPU, and
``--arch xlstm-350m --no-reduced`` full-width xLSTM on the card.

``--plan`` mode (the counterpart of the reference's ``plan_main`` and, with
``--engine``, ``engine_plan_main``) serves on :class:`ElasticMeshManager`
plans over a pool of ``max(counts)`` slots on the one device, or over the
world's ranks (below):

    python -m repro_torch.launch.serve --arch <id> --plan 8,4 --revoke-after 3
        [--cache-policy drop|migrate] [--engine]

``--plan 8,4 --revoke-after 3`` decodes 3 tokens on the 8-slot plan, then
simulates a spot revocation: the params move to the 4-slot plan as a
PARAMS-ONLY reshard (its bytes asserted below the training path's) and
the dense cache either moves with them (``--cache-policy migrate``,
priced by ``reshard_bytes`` over the cache placements) or is dropped and
re-prefilled from the prompt and the tokens fed so far (``drop``, the
default). With ``--engine`` the replica is the continuous-batching
``DecodeEngine`` (paged pool; ``drop`` only): the dying engine's pool is
released, its streams drain onto a fresh engine for the new plan
(``drain_replica``) and resume by re-prefilling prompt + committed
tokens. Each decode step is timed into a ``ThroughputTracker`` keyed by
the plan. A ``first row:`` line and a ``PLAN_JSON`` line report the
streams and the byte accounting with the reference's keys, plus
``recover_seconds`` (wall seconds from the revocation to the first token
decoded on the replacement, ended by a device sync) and the prefill and
decode timings. The plan modes hold the params in ``param_dtype`` (f32),
as the reference's plan modes hold them, so the byte columns equal the
reference's; the host path stores weight matrices in the compute dtype.

Over the ranks of a world the plans are the world's: each rank of a plan
holds its slices of the params (``param_shardings``: what a revocation
moves), computes with the whole params gathered once a plan within the
plan's group, and prefills and decodes the rows of its ``data``
coordinate (the cache at full length, ``rows_shardings``); the ``model``
axis shards what moves, not what computes. The revocation moves the held
slices to the new plan's placements; ``migrate`` moves each rank's
``cache_shardings`` slice of the cache (its rows narrowed, a view) and
gathers it to the new rows. ``PLAN_JSON`` adds ``params_received`` and
``cache_received`` (bytes received, summed over ranks: the priced
``params_bytes`` and ``cache_bytes``), ``params_gather_bytes`` and
``cache_gather_bytes`` (the gathers to the compute placements),
``move_seconds`` (each move's slowest rank, from a barrier to a device
sync), ``data_ranks_agree`` and each rank's prefills and decode steps.

``--trace PATH`` (every mode) records the event timeline (engine lane
events, drains) to a JSONL file: ``python -m repro_torch.obs.replay PATH``
replays it, ``python -m repro_torch.obs.export PATH`` renders it.

``--int8-cache`` (every mode) keeps the KV cache in int8 with a scale per
(row, kv head): the dense cache of the host and ``--plan`` paths (whose
``migrate`` moves the scales with the codes, and whose byte columns count
them) and the engine's paged pool.

Params come from ``torch.Generator(device).manual_seed(seed)``. The prompts
are ``numpy.random.RandomState(seed).randint(0, vocab, (batch, prompt_len))``
and a VLM's stub patch embeddings ``(batch, vision_tokens, vision_width)``
or an encoder-decoder's stub frame embeddings ``(batch, encoder_seq_len,
d_model)`` are drawn in bf16 from the same seeded torch generator, after
the params: the reference draws them with ``jax.random`` (frames from key
2, patches from key 3), whose numbers the port cannot reproduce, so the
two launchers serve different inputs. A VLM serves in the host and the
dense ``--plan`` paths; the engine serves text only. An encoder-decoder
(``--arch whisper-tiny``) serves in the host and the dense ``--plan``
paths: its encoder's output, the ``memory``, is a leaf of the dense cache,
so ``--cache-policy migrate`` moves it with the KV cache (``cache_bytes``
counts it) and ``drop`` re-runs the encoder over the frames in the
re-prefill, as the reference's ``plan_main`` does, e.g.
``--arch whisper-tiny --plan 8,4 --revoke-after 3 --device cpu``.
``--engine`` refuses it: the paged pool takes DENSE blocks only, as the
reference's does.
"""
from __future__ import annotations

import argparse
import dataclasses
import json
import os
import time
from typing import Any, List, Optional, Sequence

import numpy as np
import torch

from repro_torch import resolve_device
from repro_torch.config import ShardingLayout, get_arch, list_archs
from repro_torch.dist import (
    ElasticMeshManager,
    ThroughputTracker,
    batch_shardings,
    cache_shardings,
    elastic,
    gather_tree,
    move_leaves,
    narrow_tree,
    param_shardings,
    placement_device,
    replicated,
    reshard_bytes,
    reshard_tree,
    rows_shardings,
)
from repro_torch.launch.mesh import local_world_size, make_host_mesh, run_world, world
from repro_torch.models import build_model, common
from repro_torch.models.layers import PAGE_SIZE
from repro_torch.models.zoo import Model, input_specs
from repro_torch.obs import events as obs_ev
from repro_torch.obs import get_logger
from repro_torch.obs.recorder import current as obs_current
from repro_torch.serve.autoscale import drain_replica
from repro_torch.serve.engine import DecodeEngine, Request
from repro_torch.serve.migrate import assert_params_only, migrate_cache, replica_param_bytes_moved
from repro_torch.train.steps import build_decode_step, build_prefill_step

log = get_logger("launch.serve")


@dataclasses.dataclass
class ServeResult:
    tokens: torch.Tensor          # (B, new_tokens) int32 greedy tokens, on the host
    logits: List[torch.Tensor]    # per generated token, the (B, V) logits it was taken from
    cache: Any                    # the cache after the last decode step
    prefill_seconds: float        # prefill + first argmax, ended by a device sync
    decode_seconds: float         # all decode steps, ended by a device sync

    @property
    def decode_steps(self) -> int:
        return len(self.logits) - 1


def _sync(device: torch.device) -> None:
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def greedy_serve(model: Model, params, tokens: torch.Tensor, new_tokens: int,
                 layout: ShardingLayout = ShardingLayout(attn_impl="flash"),
                 patches: Optional[torch.Tensor] = None,
                 frames: Optional[torch.Tensor] = None) -> ServeResult:
    """Prefill ``tokens`` (B, S) in one batch (after a VLM's ``patches``;
    an encoder-decoder encodes its ``frames`` first), then greedy-decode
    until every row has ``new_tokens`` tokens; the cache holds S +
    new_tokens positions and the vision prefix (a ring buffer of the window
    for sliding attention; xLSTM keeps only its constant-size recurrent
    states; an encoder-decoder keeps its encoder's output beside them).
    ``layout.int8_kv_cache`` makes the cache int8."""
    device = tokens.device
    S = tokens.shape[1]
    prefill = build_prefill_step(model, layout, S + new_tokens)
    decode = build_decode_step(model, layout)

    t0 = time.perf_counter()
    logits, cache = prefill(params, _batch(tokens, patches, frames))
    tok = logits[:, -1].argmax(-1).to(torch.int32)[:, None]
    _sync(device)
    prefill_s = time.perf_counter() - t0

    toks, outs = [tok], [logits[:, -1]]
    t0 = time.perf_counter()
    for i in range(new_tokens - 1):
        logits, cache = decode(params, cache, tok, S + i)
        tok = logits[:, -1].argmax(-1).to(torch.int32)[:, None]
        toks.append(tok)
        outs.append(logits[:, -1])
    _sync(device)
    return ServeResult(torch.cat(toks, dim=1).cpu(), outs, cache, prefill_s,
                       time.perf_counter() - t0)


def _batch(tokens: torch.Tensor, patches: Optional[torch.Tensor],
           frames: Optional[torch.Tensor] = None) -> dict:
    out = {"tokens": tokens}
    if patches is not None:
        out["patches"] = patches
    if frames is not None:
        out["frames"] = frames
    return out


# the plan modes prefill through the flash kernel's entry point; the
# placements follow the layout's default (baseline) rule table
PLAN_LAYOUT = ShardingLayout(attn_impl="flash")


def _steps_per_sec(tracker: ThroughputTracker) -> dict:
    return {f"{k[1][0]}x{k[1][1]}": round(v, 3) for k, v in tracker.measured.items()}


def _no_migration(cache_policy: str) -> dict:
    return {"params_bytes": 0, "cache_bytes": 0, "train_path_bytes": 0,
            "migrated_at": None, "cache_policy": cache_policy}


def _refuse_encoder(cfg, engine: bool) -> None:
    """``--engine`` pages its KV pool, and the reference pages DENSE blocks
    only (its ``paged_cache_specs`` refuses any other kind, reached from
    its engine): an encoder-decoder serves on the dense plans, where its
    encoder's ``memory`` rides in the cache, not in the engine."""
    if engine and cfg.encoder_layers:
        raise NotImplementedError(
            f"--engine pages DENSE blocks only, as the reference's paged cache does; "
            f"{cfg.name} is {cfg.block.value}: serve it with --plan without --engine")


def serve_plan(model: Model, params, prompts: np.ndarray, new_tokens: int,
               counts: Sequence[int], *, revoke_after: int = 0, cache_policy: str = "drop",
               engine: bool = False, device="cuda",
               tracker: Optional[ThroughputTracker] = None, int8_cache: bool = False,
               patches: Optional[torch.Tensor] = None,
               frames: Optional[torch.Tensor] = None) -> dict:
    """Serve ``prompts`` (B, S) (after a VLM's ``patches``; an
    encoder-decoder encodes its ``frames`` first; both dense only) on the
    plans for ``counts`` (a pool of ``max(counts)`` slots on ``device``, or,
    once this process has joined a world, the world's ranks, each on its
    own device: every rank calls this alike with the whole params);
    with a second count, revoke the first plan after ``revoke_after``
    decode steps and migrate to the second. Each decode step is timed into
    ``tracker`` (a fresh ``ThroughputTracker`` by default) under its plan's
    key. ``int8_cache``: the int8 KV cache. Returns the ``PLAN_JSON``
    object (on every rank of a world)."""
    _refuse_encoder(model.cfg, engine)
    if engine and cache_policy != "drop":
        raise SystemExit("--engine supports --cache-policy drop only "
                         "(pool pages die with the instance)")
    on_ranks = world() is not None
    man = ElasticMeshManager() if on_ranks else ElasticMeshManager(
        [resolve_device(device)] * max(counts))
    revoke_after = revoke_after if len(counts) > 1 else 0
    layout = dataclasses.replace(PLAN_LAYOUT, int8_kv_cache=int8_cache)
    tracker = tracker if tracker is not None else ThroughputTracker()
    prompts = np.asarray(prompts, np.int32)
    args = (model, params, prompts, new_tokens, list(counts), revoke_after)
    if engine:
        run = _engine_ranks if on_ranks else _engine_plan
        return run(*args, man, layout, tracker)
    run = _dense_ranks if on_ranks else _dense_plan
    return run(*args, cache_policy, man, layout, tracker, patches, frames)


def _dense_plan(model, params, prompts, new_tokens, counts, revoke_after, cache_policy,
                man, layout, tracker, patches, frames) -> dict:
    """Lock-step prefill + greedy decode on the dense cache, with a live
    shape migration at ``revoke_after``. An encoder-decoder's ``memory``
    is a leaf of the cache: ``migrate`` moves it with the KV cache (and
    prices its bytes with theirs), ``drop`` loses it with them and the
    re-prefill runs the encoder over the frames again."""
    B, S = prompts.shape
    total = S + new_tokens
    c_specs = model.cache_specs(B, total, int8=layout.int8_kv_cache)
    plan = man.plan_for(counts[0])
    p_sh = param_shardings(model.specs, plan.mesh, layout)
    c_sh = cache_shardings(c_specs, plan.mesh, layout)
    params = reshard_tree(params, p_sh)
    prefill = build_prefill_step(model, layout, total)
    decode = build_decode_step(model, layout)
    tokens = torch.as_tensor(prompts, device=placement_device(replicated(plan.mesh)))

    migrated = _no_migration(cache_policy)
    t0 = time.perf_counter()
    logits, cache = prefill(params, _batch(tokens, patches, frames))
    tok = logits[:, -1].argmax(-1).to(torch.int32)[:, None]
    toks = [tok.cpu()]
    prefill_s = time.perf_counter() - t0
    log.info("plan up", devices=plan.device_count, mesh=str(plan.mesh_shape))

    decode_s, recover_s, t_revoke = 0.0, None, None
    i = 0
    while i < new_tokens - 1:
        if revoke_after and i == revoke_after:
            # --- spot revocation: live shape migration ---------------------
            t_revoke = time.perf_counter()
            gen = torch.cat(toks, dim=1)
            plan = man.plan_for(counts[1])
            old_p_sh, old_c_sh = p_sh, c_sh
            p_sh = param_shardings(model.specs, plan.mesh, layout)
            c_sh = cache_shardings(c_specs, plan.mesh, layout)
            moved = replica_param_bytes_moved(params, old_p_sh, p_sh)
            params = reshard_tree(params, p_sh)
            migrated["params_bytes"] = moved
            migrated["train_path_bytes"] = assert_params_only(moved, model)
            migrated["migrated_at"] = i
            if cache_policy == "migrate":
                migrated["cache_bytes"] = reshard_bytes(cache, old_c_sh, c_sh)
            # drop: the cache died with the instance (None); migrate: a copy
            # on the new placements that shares no storage with the old one
            cache = migrate_cache(cache, c_sh, cache_policy)
            if cache is None:
                # re-prefill the prompt + every token already fed to the old
                # cache (the newest token rides the next decode call), billed
                # as recompute on the replacement
                t1 = time.perf_counter()
                refill = torch.cat([tokens, gen[:, :i].to(tokens.device)], dim=1)
                _, cache = prefill(params, _batch(refill, patches, frames))
                _sync(tokens.device)
                prefill_s += time.perf_counter() - t1
            log.info("revoked: migrated to replacement plan", token=i,
                     devices=plan.device_count, mesh=str(plan.mesh_shape),
                     params_bytes=migrated["params_bytes"],
                     train_path_bytes=migrated["train_path_bytes"],
                     cache_bytes=migrated["cache_bytes"], cache_policy=cache_policy)
        t0 = time.perf_counter()
        logits, cache = decode(params, cache, tok, S + i)
        tok = logits[:, -1].argmax(-1).to(torch.int32)[:, None]
        _sync(tokens.device)
        t1 = time.perf_counter()
        tracker.observe(plan.key, 1, t1 - t0)
        decode_s += t1 - t0
        if t_revoke is not None and recover_s is None:
            recover_s = t1 - t_revoke
        toks.append(tok.cpu())
        i += 1

    rows = torch.cat(toks, dim=1)
    return {"plans": counts, "tokens": rows.tolist(),
            "measured_steps_per_sec": _steps_per_sec(tracker), **migrated,
            "recover_seconds": recover_s, "prefill_seconds": prefill_s,
            "decode_seconds": decode_s, "decode_steps": len(toks) - 1}


def _engine_plan(model, params, prompts, new_tokens, counts, revoke_after, man, layout,
                 tracker) -> dict:
    """The continuous-batching engine on plans: at ``revoke_after`` the
    dying engine's pool is released (pages die with the instance) and its
    streams drain onto a fresh engine for the new plan."""
    B, S = prompts.shape
    total = S + new_tokens
    num_pages = B * (-(-total // PAGE_SIZE)) + 1

    def replica(plan):
        sh = param_shardings(model.specs, plan.mesh, layout)
        eng = DecodeEngine(model, layout, placement_device(replicated(plan.mesh)), lanes=B,
                           num_pages=num_pages, max_context=total, tracker=tracker,
                           tracker_key=plan.key)
        return eng, sh

    plan = man.plan_for(counts[0])
    engine, p_sh = replica(plan)
    params = reshard_tree(params, p_sh)
    for b in range(B):
        engine.submit(Request(rid=b, prompt=prompts[b], max_new_tokens=new_tokens))
    log.info("engine plan up", devices=plan.device_count, mesh=str(plan.mesh_shape),
             lanes=B, pages=num_pages, pool_bytes=engine.pool_bytes,
             int8_cache=layout.int8_kv_cache)

    migrated = _no_migration("drop")
    engines = [engine]
    recover_s, t_revoke = None, None
    i = 0
    while engine.in_flight:
        if revoke_after and i == revoke_after:
            # the revocation is the same move a scale-down makes: drain the
            # dying engine's streams onto the replacement replica
            t_revoke = time.perf_counter()
            dying, old_p_sh = engine, p_sh
            dying.release_pool()
            plan = man.plan_for(counts[1])
            engine, p_sh = replica(plan)
            engines.append(engine)
            moved = replica_param_bytes_moved(params, old_p_sh, p_sh)
            params = reshard_tree(params, p_sh)
            migrated["params_bytes"] = moved
            migrated["train_path_bytes"] = assert_params_only(moved, model)
            migrated["migrated_at"] = i
            n_drained = drain_replica(dying, engine)
            log.info("revoked: streams drained to replacement", step=i, shed=n_drained,
                     devices=plan.device_count, mesh=str(plan.mesh_shape),
                     params_bytes=migrated["params_bytes"],
                     train_path_bytes=migrated["train_path_bytes"])
        engine.step(params)          # ends with a device sync
        if t_revoke is not None and recover_s is None:
            recover_s = time.perf_counter() - t_revoke
        i += 1

    done = {c.rid: c.tokens for c in engine.completions}
    rows = np.asarray([done[b] for b in range(B)], np.int32)
    return {"plans": counts, "engine": True, "tokens": rows.tolist(),
            "measured_steps_per_sec": _steps_per_sec(tracker),
            "engine_tokens_per_sec": round(engine.measured_tokens_per_sec, 3), **migrated,
            "recover_seconds": recover_s,
            "prefill_seconds": sum(e.prefill_seconds for e in engines),
            "decode_seconds": sum(e.decode_seconds for e in engines),
            "decode_steps": sum(e.decode_steps for e in engines),
            "prefills": sum(e.prefills for e in engines),
            "engine_tokens_per_sec_before": (engines[0].measured_tokens_per_sec
                                             if len(engines) > 1 else None)}


# ---------------------------------------------------------------------------
# The plans over the ranks of a world
# ---------------------------------------------------------------------------

@dataclasses.dataclass
class _Ranks:
    """A plan over the world's ranks as this rank sees it: its process
    group, the placement of the (B, S) prompts (rows over ``data``), and
    this rank's rows (None outside the plan)."""

    plan: Any
    group: Any
    tokens: Any
    rows: Optional[slice]

    @classmethod
    def of(cls, man: ElasticMeshManager, count: int, prompts: np.ndarray) -> "_Ranks":
        plan = man.plan_for(count)        # every rank, in the same order: new_group
        return cls.on_mesh(plan.mesh, prompts, plan)

    @classmethod
    def on_mesh(cls, mesh, prompts: np.ndarray, plan=None) -> "_Ranks":
        from repro_torch.launch.mesh import group_for

        tokens = batch_shardings({"tokens": prompts}, mesh)["tokens"]
        box = tokens.box(prompts.shape, world().rank)
        return cls(plan, group_for(mesh.slots), tokens, None if box is None else slice(*box[0]))


def _whole_rows(parts: Sequence[torch.Tensor], on: _Ranks, B: int) -> tuple:
    """The (B, ...) rows that the plan's ranks computed, from every rank's
    own rows (``parts``, in rank order): each taken from its data leader.
    And whether every rank of a ``data`` coordinate gave its leader's bits."""
    from repro_torch.dist.elastic import data_leaders

    whole = parts[0].new_empty((B,) + tuple(parts[0].shape[1:]))
    mesh = on.tokens.mesh
    part = dict(zip(mesh.slots, parts))
    boxes = {r: slice(*on.tokens.box((B, 1), r)[0]) for r in mesh.slots}
    for r in data_leaders(mesh):
        whole[boxes[r]] = part[r]
    return whole, all(torch.equal(part[r], whole[boxes[r]]) for r in mesh.slots)


def _gather_rows(rows: torch.Tensor, on: _Ranks, B: int) -> tuple:
    """Every rank of the plan: the whole (B, n) matrix of the rows each
    computed (``rows``, this rank's (rows, n)), on the host, by one
    all-gather over the plan's group; and whether the ranks of each
    ``data`` coordinate agreed bit for bit."""
    import torch.distributed as dist

    parts = [torch.empty_like(rows) for _ in on.tokens.mesh.slots]
    dist.all_gather(parts, rows.contiguous(), group=on.group)
    return _whole_rows([p.cpu() for p in parts], on, B)


def _start_move() -> float:
    """Line up every rank of the world and start a move's clock."""
    import torch.distributed as dist

    dist.barrier()
    return time.perf_counter()


def _moved(received: int, t0: float) -> tuple:
    """(bytes received summed over the world's ranks, the slowest rank's
    seconds) of a move every rank started at ``t0``."""
    import torch.distributed as dist

    dev = world().device
    _sync(dev)
    secs = time.perf_counter() - t0
    got = torch.tensor([received], dtype=torch.int64, device=dev)
    slow = torch.tensor([secs], dtype=torch.float64, device=dev)
    dist.all_reduce(got)
    dist.all_reduce(slow, op=dist.ReduceOp.MAX)
    return int(got.item()), float(slow.item())


def _held(params, p_sh) -> Any:
    """This rank's slices of the whole ``params`` (which every rank holds,
    made alike) under the plan's ``p_sh``: what a revocation moves. No byte
    moves; a leaf the rank holds whole stays the caller's tensor, so the
    moves that follow never free it."""
    leaves, unflatten = common.tree_flatten(params)
    start = common.tree_flatten(elastic.everywhere(params))[0]
    return unflatten(move_leaves(leaves, start, common.tree_flatten(p_sh)[0])[0])


def _compute_params(held, p_sh, on: _Ranks) -> tuple:
    """The whole params on each rank of the plan, gathered once from the
    held slices within its group (serving never updates them), and the
    bytes this rank received; (None, 0) outside the plan."""
    if on.rows is None:
        return None, 0
    whole = common.tree_map(lambda _: replicated(on.plan.mesh), p_sh)
    return gather_tree(held, p_sh, whole, on.group)


def _sized(params) -> Any:
    """Shape and dtype of every leaf (meta tensors): what the params moved
    are priced by once each rank holds only its slices."""
    return common.tree_map(lambda t: torch.empty(t.shape, dtype=t.dtype, device="meta"),
                           params)


def _all_ranks(mine: dict) -> list:
    """Every rank's ``mine``, in rank order, on every rank."""
    import torch.distributed as dist

    every = [None] * world().size
    dist.all_gather_object(every, mine)
    return every


def _from_rank0(out: Any) -> Any:
    """Rank 0's ``out`` on every rank."""
    import torch.distributed as dist

    box = [out]
    dist.broadcast_object_list(box, src=0)
    return box[0]


def _move_params(sized, held, on: _Ranks, p_sh_old, p_sh, migrated: dict, moves: dict):
    """The revocation's params: the held slices move to the new plan's
    placements over the world's group (a rank leaving the plan ends with
    None), then the new plan's ranks gather the whole params again."""
    migrated["params_bytes"] = replica_param_bytes_moved(sized, p_sh_old, p_sh)
    t0 = _start_move()
    before = elastic.stats.bytes_received
    # the held leaves may share storage with the caller's params: kept, not freed
    held = reshard_tree(held, p_sh, p_sh_old, release=False)
    migrated["params_received"], moves["params"] = _moved(
        elastic.stats.bytes_received - before, t0)
    t0 = _start_move()
    params, got = _compute_params(held, p_sh, on)
    migrated["params_gather_bytes"], moves["params_gather"] = _moved(got, t0)
    return held, params


def _dense_ranks(model, params, prompts, new_tokens, counts, revoke_after, cache_policy,
                 man, layout, tracker, patches, frames) -> dict:
    """``_dense_plan`` over the world's ranks. Each rank holds its slices of
    the params by ``param_shardings`` and computes with the whole params,
    gathered once a plan within its group; each prefills and decodes the
    rows of its ``data`` coordinate (the cache at full length: the rows
    placement). Every rank keeps the whole (B, t) token matrix, each step's
    rows all-gathered from the plan's data leaders; that collective ends
    the step, so the step's clock is the slowest rank's. At the revocation
    the held params move to the new plan, then are gathered again;
    ``migrate`` narrows each rank's cache to its ``cache_shardings`` slice
    (a view), moves those slices to the new plan's (the priced
    ``cache_bytes``) and gathers them to the new rows (``cache_gather_bytes``);
    ``drop`` re-prefills the new rows. A rank outside a plan joins every
    move of the world and no step."""
    import torch.distributed as dist

    w = world()
    dev = w.device
    B, S = prompts.shape
    total = S + new_tokens
    c_specs = model.cache_specs(B, total, int8=layout.int8_kv_cache)
    sized = _sized(params)
    on = _Ranks.of(man, counts[0], prompts)
    p_sh = param_shardings(model.specs, on.plan.mesh, layout)
    held = _held(params, p_sh)
    params, _ = _compute_params(held, p_sh, on)
    prefill = build_prefill_step(model, layout, total)
    decode = build_decode_step(model, layout)
    tokens = torch.as_tensor(prompts, device=dev)

    def inputs(rows, toks):
        return _batch(toks[rows], None if patches is None else patches[rows],
                      None if frames is None else frames[rows])

    migrated = {**_no_migration(cache_policy), "params_received": 0, "cache_received": 0,
                "params_gather_bytes": 0, "cache_gather_bytes": 0}
    moves: dict = {}
    agree, prefills, steps = True, 0, 0
    cache, toks, prefill_s = None, [], 0.0
    t0 = time.perf_counter()
    if on.rows is not None:
        logits, cache = prefill(params, inputs(on.rows, tokens))
        prefills += 1
        first, ok = _gather_rows(logits[:, -1].argmax(-1).to(torch.int32)[:, None], on, B)
        toks, agree = [first], agree and ok
        prefill_s = time.perf_counter() - t0
    log.info("plan up", devices=on.plan.device_count, mesh=str(on.plan.mesh_shape),
             rank=w.rank)

    decode_s, recover_s, t_revoke = 0.0, None, None
    i = 0
    while i < new_tokens - 1:
        if revoke_after and i == revoke_after:
            # --- spot revocation: live shape migration over the ranks -------
            t_revoke = time.perf_counter()
            gen = torch.cat(toks, dim=1).to(dev) if toks else \
                torch.empty((B, i + 1), dtype=torch.int32, device=dev)
            dist.broadcast(gen, src=0)              # for a rank joining the plan
            gen = gen.cpu()
            old_on, old_p_sh = on, p_sh
            old_c_sh = cache_shardings(c_specs, old_on.plan.mesh, layout)
            on = _Ranks.of(man, counts[1], prompts)
            p_sh = param_shardings(model.specs, on.plan.mesh, layout)
            c_sh = cache_shardings(c_specs, on.plan.mesh, layout)
            params = None
            held, params = _move_params(sized, held, on, old_p_sh, p_sh, migrated, moves)
            migrated["train_path_bytes"] = assert_params_only(migrated["params_bytes"], model)
            migrated["migrated_at"] = i
            if cache_policy == "migrate":
                migrated["cache_bytes"] = reshard_bytes(c_specs, old_c_sh, c_sh)
                held_c = common.tree_map(lambda _: None, c_specs) if cache is None else \
                    narrow_tree(cache, rows_shardings(c_specs, old_on.plan.mesh), old_c_sh)
                cache = None
                t0 = _start_move()
                before = elastic.stats.bytes_received
                held_c = migrate_cache(held_c, c_sh, cache_policy, old=old_c_sh)
                migrated["cache_received"], moves["cache"] = _moved(
                    elastic.stats.bytes_received - before, t0)
                t0 = _start_move()
                got = 0
                if on.rows is not None:
                    cache, got = gather_tree(held_c, c_sh, rows_shardings(c_specs, on.plan.mesh),
                                             on.group)
                del held_c
                migrated["cache_gather_bytes"], moves["cache_gather"] = _moved(got, t0)
            else:
                cache = None
                if on.rows is not None:
                    # re-prefill the prompt + every token already fed to the old
                    # cache (the newest token rides the next decode call)
                    t1 = time.perf_counter()
                    refill = torch.cat([tokens, gen[:, :i].to(dev)], dim=1)
                    _, cache = prefill(params, inputs(on.rows, refill))
                    prefills += 1
                    _sync(dev)
                    prefill_s += time.perf_counter() - t1
            toks = [gen]
            log.info("revoked: migrated to replacement plan", token=i, rank=w.rank,
                     devices=on.plan.device_count, mesh=str(on.plan.mesh_shape),
                     **{k: migrated[k] for k in ("params_bytes", "params_received",
                                                 "cache_bytes", "cache_received",
                                                 "cache_gather_bytes")},
                     cache_policy=cache_policy)
        if on.rows is None:          # outside the plan: no step to take
            if not revoke_after or i >= revoke_after:
                break
            i = revoke_after
            continue
        t0 = time.perf_counter()
        tok = toks[-1][:, -1:][on.rows].to(dev)
        logits, cache = decode(params, cache, tok, S + i)
        nxt, ok = _gather_rows(logits[:, -1].argmax(-1).to(torch.int32)[:, None], on, B)
        t1 = time.perf_counter()
        agree = agree and ok
        tracker.observe(on.plan.key, 1, t1 - t0)
        decode_s += t1 - t0
        steps += 1
        if t_revoke is not None and recover_s is None:
            recover_s = t1 - t_revoke
        toks.append(nxt)
        i += 1

    mine = {"rank": w.rank, "prefills": prefills, "decode_steps": steps, "agree": agree}
    ranks = _all_ranks(mine)
    out = None
    if w.rank == 0:
        rows = torch.cat(toks, dim=1)
        out = {"plans": counts, "tokens": rows.tolist(),
               "measured_steps_per_sec": _steps_per_sec(tracker), **migrated,
               "recover_seconds": recover_s, "prefill_seconds": prefill_s,
               "decode_seconds": decode_s, "decode_steps": rows.shape[1] - 1,
               "move_seconds": moves, "data_ranks_agree": all(r["agree"] for r in ranks),
               "ranks": [{k: r[k] for k in ("rank", "prefills", "decode_steps")}
                         for r in ranks]}
    return _from_rank0(out)


def _engine_ranks(model, params, prompts, new_tokens, counts, revoke_after, man, layout,
                  tracker) -> dict:
    """``_engine_plan`` over the world's ranks: each rank of the plan runs a
    ``DecodeEngine`` on its card for the requests whose rows its ``data``
    coordinate holds (``batch_shardings``), with a lane a row. At the
    revocation every dying engine releases its pool (the pages die with the
    instance) and sheds its streams; their host state (prompt, committed
    tokens, ``max_new_tokens``) crosses the ranks by ``all_gather_object``,
    the params move as on the dense plans, and each engine of the new plan
    takes its rows' requests in rid order and resumes them by re-prefill.
    Completions and rates are gathered to every rank; each row counts once
    (the lowest rank holding it)."""
    import torch.distributed as dist

    from repro_torch.dist.elastic import first_holder

    w = world()
    dev = w.device
    B, S = prompts.shape
    total = S + new_tokens
    pages_a_row = -(-total // PAGE_SIZE)
    sized = _sized(params)

    def replica(on):
        if on.rows is None:
            return None
        n = on.rows.stop - on.rows.start
        return DecodeEngine(model, layout, dev, lanes=n, num_pages=n * pages_a_row + 1,
                            max_context=total, tracker=tracker, tracker_key=on.plan.key)

    def world_in_flight(eng) -> int:
        got = torch.tensor([eng.in_flight if eng is not None else 0], device=dev)
        dist.all_reduce(got)
        return int(got.item())

    def summary(eng, k: int, counted: bool) -> dict:
        """What the results need of an engine on plan k (0 before the
        revocation, 1 after): a dying engine is dropped once summarized,
        with the compute copy of the params its last step held."""
        return {"plan": k, "counted": counted,
                "done": {c.rid: c.tokens for c in eng.completions},
                **{a: getattr(eng, a) for a in ("decoded_tokens", "decode_seconds", "prefills",
                                                "decode_steps", "prefill_seconds")}}

    on = _Ranks.of(man, counts[0], prompts)
    p_sh = param_shardings(model.specs, on.plan.mesh, layout)
    held = _held(params, p_sh)
    params, _ = _compute_params(held, p_sh, on)
    engine = replica(on)
    if engine is not None:
        for b in range(on.rows.start, on.rows.stop):
            engine.submit(Request(rid=b, prompt=prompts[b], max_new_tokens=new_tokens))
        log.info("engine plan up", devices=on.plan.device_count, mesh=str(on.plan.mesh_shape),
                 rank=w.rank, lanes=engine.lanes, pages=engine.num_pages,
                 pool_bytes=engine.pool_bytes, int8_cache=layout.int8_kv_cache)

    migrated = {**_no_migration("drop"), "params_received": 0, "cache_received": 0,
                "params_gather_bytes": 0, "cache_gather_bytes": 0}
    moves: dict = {}
    engines: list = []          # this rank's engines' summaries
    recover_s, t_revoke = None, None
    i = 0
    in_flight = world_in_flight(engine)
    while in_flight:
        if revoke_after and i == revoke_after:
            t_revoke = time.perf_counter()
            shed = []
            if engine is not None:
                engine.release_pool()
                shed = engine.shed()
                engines.append(summary(engine, 0, first_holder(on.tokens, prompts.shape)))
            resumed = {}
            for reqs in _all_ranks([dataclasses.astuple(r) for r in shed]):
                for r in reqs:
                    resumed.setdefault(r[0], Request(*r))
            rec = obs_current()
            if rec.enabled and engine is not None:
                rec.emit(obs_ev.Drain(t=float(engine.steps), moved_requests=len(resumed)))
            engine = None
            old_p_sh = p_sh
            on = _Ranks.of(man, counts[1], prompts)
            p_sh = param_shardings(model.specs, on.plan.mesh, layout)
            params = None
            held, params = _move_params(sized, held, on, old_p_sh, p_sh, migrated, moves)
            migrated["train_path_bytes"] = assert_params_only(migrated["params_bytes"], model)
            migrated["migrated_at"] = i
            engine = replica(on)
            if engine is not None:
                for rid in sorted(resumed):
                    if on.rows.start <= rid < on.rows.stop:
                        engine.submit(resumed[rid])
            log.info("revoked: streams drained to replacement", step=i, rank=w.rank,
                     shed=len(resumed), devices=on.plan.device_count,
                     mesh=str(on.plan.mesh_shape), params_bytes=migrated["params_bytes"],
                     params_received=migrated["params_received"])
        if engine is not None:
            engine.step(params)          # ends with a device sync
        in_flight = world_in_flight(engine)
        if t_revoke is not None and recover_s is None:
            recover_s = time.perf_counter() - t_revoke
        i += 1

    if engine is not None:
        engines.append(summary(engine, int(t_revoke is not None),
                               first_holder(on.tokens, prompts.shape)))
    mine = {"rank": w.rank, "done": {rid: t for e in engines for rid, t in e["done"].items()},
            "engines": [(e["plan"], e["decoded_tokens"], e["decode_seconds"])
                        for e in engines if e["counted"]],
            **{a: sum(e[a] for e in engines)
               for a in ("prefills", "decode_steps", "prefill_seconds", "decode_seconds")}}
    ranks = _all_ranks(mine)
    done: dict = {}
    for r in ranks:
        for rid, toks in r["done"].items():
            done.setdefault(rid, toks)
    agree = all(done[rid] == toks for r in ranks for rid, toks in r["done"].items())

    def rate(k: int) -> float:
        """Tokens/s of plan k's engines: each row once, over the slowest
        engine's decode seconds."""
        parts = [(n, secs) for r in ranks for j, n, secs in r["engines"] if j == k]
        secs = max((t for _, t in parts), default=0.0)
        return round(sum(n for n, _ in parts) / secs, 3) if secs > 0 else 0.0

    zero = ranks[0]
    revoked = t_revoke is not None
    sps, recover_s = _from_rank0((_steps_per_sec(tracker), recover_s) if w.rank == 0
                                 else None)
    return {"plans": counts, "engine": True,
            "tokens": [done[b] for b in range(B)],
            "measured_steps_per_sec": sps,
            "engine_tokens_per_sec": rate(int(revoked)), **migrated,
            "recover_seconds": recover_s,
            "prefill_seconds": zero["prefill_seconds"],
            "decode_seconds": zero["decode_seconds"], "decode_steps": zero["decode_steps"],
            "prefills": zero["prefills"],
            "engine_tokens_per_sec_before": rate(0) if revoked else None,
            "move_seconds": moves, "data_ranks_agree": agree,
            "ranks": [{k: r[k] for k in ("rank", "prefills", "decode_steps")} for r in ranks]}


def _model_and_prompts(args):
    w = world()
    device = w.device if w is not None else resolve_device(args.device)
    cfg = get_arch(args.arch)
    if args.reduced:
        cfg = cfg.reduced()
    prompts = np.random.RandomState(args.seed).randint(
        0, cfg.vocab_size, (args.batch, args.prompt_len)).astype(np.int32)
    return build_model(cfg), prompts, device


def _params_and_inputs(model: Model, args, device, dtype=None):
    """Params from the seeded generator, then the stub frontends' inputs
    that ``input_specs`` names beside the tokens (an encoder-decoder's
    ``frames``, a VLM's ``patches``; bf16, standard normal) from the same
    generator, by name; an empty dict for a text model."""
    gen = torch.Generator(device=device).manual_seed(args.seed)
    params = model.init(gen, device, dtype)
    specs = input_specs(model.cfg, args.batch, args.prompt_len, "prefill")
    return params, {name: torch.randn(shape, generator=gen, device=device).to(torch.bfloat16)
                    for name, (shape, _) in specs.items() if name != "tokens"}


def _say(*parts) -> None:
    if world() is None or world().rank == 0:
        print(*parts, flush=True)


def plan_main(args) -> dict:
    """``--plan`` (and ``--engine``): print the ``first row:`` and
    ``PLAN_JSON`` lines (rank 0 of a world); returns the ``PLAN_JSON``
    object."""
    model, prompts, device = _model_and_prompts(args)
    _refuse_encoder(model.cfg, args.engine)
    # param_dtype (f32) storage, as the reference's plan modes hold the params
    params, inputs = _params_and_inputs(model, args, device)
    out = serve_plan(model, params, prompts, args.new_tokens,
                     [int(x) for x in args.plan.split(",")], revoke_after=args.revoke_after,
                     cache_policy=args.cache_policy, engine=args.engine, device=device,
                     int8_cache=args.int8_cache, patches=inputs.get("patches"),
                     frames=inputs.get("frames"))
    _say("first row:", out["tokens"][0])
    _say("PLAN_JSON " + json.dumps(out))
    return out


def host_main(args) -> dict:
    """The host path: lock-step batched prefill + decode on one device, or,
    in a world, on every rank over ``make_host_mesh(--model-parallel)``:
    each rank serves the rows of its ``data`` coordinate with the whole
    params (made alike on every rank from the seed; nothing moves), and
    rank 0 gathers every row."""
    model, prompt, device = _model_and_prompts(args)
    cfg = model.cfg
    mesh = make_host_mesh(getattr(args, "model_parallel", 1), device)
    params, inputs = _params_and_inputs(model, args, device, common.torch_dtype(cfg.dtype))
    layout = ShardingLayout(attn_impl="flash", int8_kv_cache=args.int8_cache)
    tokens = torch.as_tensor(prompt, device=device)
    summary = {"event": "serve done", "arch": cfg.name, "device": str(device),
               "batch": args.batch, "prompt_len": args.prompt_len,
               "int8_cache": args.int8_cache}
    if world() is None:
        res = greedy_serve(model, params, tokens, args.new_tokens, layout, **inputs)
        rows = res.tokens
    else:
        on = _Ranks.on_mesh(mesh, prompt)
        res = greedy_serve(model, params, tokens[on.rows], args.new_tokens, layout,
                           **{k: v[on.rows] for k, v in inputs.items()})
        rows, agree = _gather_rows(res.tokens.to(device), on, args.batch)
        summary.update(devices=world().size, mesh=list(mesh.grid_shape),
                       tokens=rows.tolist(), data_ranks_agree=agree)
    summary.update(prefill_ms=res.prefill_seconds * 1e3,
                   ms_per_token=res.decode_seconds / max(res.decode_steps, 1) * 1e3,
                   first_row=rows[0].tolist())
    _say(json.dumps(summary))
    return summary


def _dispatch(args) -> dict:
    if args.plan:
        return plan_main(args)
    if args.engine:
        raise SystemExit("--engine requires --plan")
    return host_main(args)


def _traced(args) -> dict:
    """``_dispatch``, recorded to ``--trace`` by rank 0 of a world (or the
    one process)."""
    if not args.trace or (world() is not None and world().rank != 0):
        return _dispatch(args)
    from repro_torch.obs.export import write_jsonl
    from repro_torch.obs.recorder import recording

    with recording() as rec:
        out = _dispatch(args)
    log.info("trace written", path=args.trace, events=write_jsonl(args.trace, rec.events))
    return out


def _rank(w, args) -> dict:
    return _traced(args)


def main(argv: Optional[Sequence[str]] = None) -> dict:
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", required=True, choices=list_archs())
    ap.add_argument("--batch", type=int, default=4)
    ap.add_argument("--prompt-len", type=int, default=64)
    ap.add_argument("--new-tokens", type=int, default=8)
    ap.add_argument("--reduced", action=argparse.BooleanOptionalAction, default=True)
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--devices", type=int, default=0,
                    help="ranks, one device each (default: every local card; 1 on the CPU)")
    ap.add_argument("--model-parallel", type=int, default=1,
                    help="host path: the model axis of the (ranks / M, M) mesh; rows are "
                         "served over the data axis")
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--int8-cache", action="store_true",
                    help="keep the KV cache (dense or paged) in int8 with a scale per row "
                         "and kv head")
    ap.add_argument("--plan", default="",
                    help="serve on ElasticMeshManager plans: comma-separated slot "
                         "counts; the second entry is the migration target (e.g. 8,4)")
    ap.add_argument("--revoke-after", type=int, default=0,
                    help="decode this many tokens, then revoke + migrate to the "
                         "second --plan entry")
    ap.add_argument("--cache-policy", choices=("drop", "migrate"), default="drop",
                    help="on migration: drop the KV cache and re-prefill, or move it")
    ap.add_argument("--engine", action="store_true",
                    help="with --plan: serve through the continuous-batching decode "
                         "engine (paged KV pool) instead of the lock-step dense cache")
    ap.add_argument("--trace", default="",
                    help="record the event timeline to this JSONL path (replay with "
                         "python -m repro_torch.obs.replay)")
    args = ap.parse_args(argv)
    if args.plan and args.model_parallel != 1:
        raise SystemExit("--model-parallel is the host path's; --plan takes its meshes "
                         "from the plans")
    n = args.devices or local_world_size(args.device)
    w = world()
    if w is not None:
        if n != w.size:
            raise ValueError(f"--devices {n} in a world of {w.size} ranks")
        return _traced(args)
    if n > 1:
        threads = max(1, (os.cpu_count() or 1) // n) if args.device == "cpu" else 0
        return run_world(_rank, n, args.device, (args,), timeout=None, threads=threads)
    return _traced(args)


if __name__ == "__main__":
    main()
