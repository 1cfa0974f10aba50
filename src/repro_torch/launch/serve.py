"""Serving launcher of the port: lock-step batched prefill + greedy decode,
and serving on mesh plans through a spot revocation.

    python -m repro_torch.launch.serve --arch <id> [--batch 4] [--prompt-len 64]
        [--new-tokens 8] [--reduced | --no-reduced] [--device cuda|cpu] [--seed 0]
        [--int8-cache] [--trace PATH]

The host path is the counterpart of ``repro.launch.serve::host_main`` on
one device (``cuda`` unless ``--device cpu``): one batched prefill over
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
plans over a pool of ``max(counts)`` slots on the one device:

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
import time
from typing import Any, List, Optional, Sequence

import numpy as np
import torch

from repro_torch import resolve_device
from repro_torch.config import ShardingLayout, get_arch, list_archs
from repro_torch.dist import (
    ElasticMeshManager,
    ThroughputTracker,
    cache_shardings,
    param_shardings,
    placement_device,
    replicated,
    reshard_bytes,
    reshard_tree,
)
from repro_torch.models import build_model, common
from repro_torch.models.layers import PAGE_SIZE
from repro_torch.models.zoo import Model, input_specs
from repro_torch.obs import get_logger
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
    plans for ``counts`` (a pool of ``max(counts)`` slots on ``device``);
    with a second count, revoke the first plan after ``revoke_after``
    decode steps and migrate to the second. Each decode step is timed into
    ``tracker`` (a fresh ``ThroughputTracker`` by default) under its plan's
    key. ``int8_cache``: the int8 KV cache. Returns the ``PLAN_JSON``
    object."""
    _refuse_encoder(model.cfg, engine)
    if engine and cache_policy != "drop":
        raise SystemExit("--engine supports --cache-policy drop only "
                         "(pool pages die with the instance)")
    dev = resolve_device(device)
    man = ElasticMeshManager([dev] * max(counts))
    revoke_after = revoke_after if len(counts) > 1 else 0
    layout = dataclasses.replace(PLAN_LAYOUT, int8_kv_cache=int8_cache)
    tracker = tracker if tracker is not None else ThroughputTracker()
    prompts = np.asarray(prompts, np.int32)
    if engine:
        return _engine_plan(model, params, prompts, new_tokens, list(counts), revoke_after,
                            man, layout, tracker)
    return _dense_plan(model, params, prompts, new_tokens, list(counts), revoke_after,
                       cache_policy, man, layout, tracker, patches, frames)


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


def _model_and_prompts(args):
    device = resolve_device(args.device)
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


def plan_main(args) -> dict:
    """``--plan`` (and ``--engine``): print the ``first row:`` and
    ``PLAN_JSON`` lines; returns the ``PLAN_JSON`` object."""
    model, prompts, device = _model_and_prompts(args)
    _refuse_encoder(model.cfg, args.engine)
    # param_dtype (f32) storage, as the reference's plan modes hold the params
    params, inputs = _params_and_inputs(model, args, device)
    out = serve_plan(model, params, prompts, args.new_tokens,
                     [int(x) for x in args.plan.split(",")], revoke_after=args.revoke_after,
                     cache_policy=args.cache_policy, engine=args.engine, device=device,
                     int8_cache=args.int8_cache, patches=inputs.get("patches"),
                     frames=inputs.get("frames"))
    print("first row:", out["tokens"][0], flush=True)
    print("PLAN_JSON " + json.dumps(out), flush=True)
    return out


def host_main(args) -> dict:
    """The host path: lock-step batched prefill + decode on one device."""
    model, prompt, device = _model_and_prompts(args)
    cfg = model.cfg
    params, inputs = _params_and_inputs(model, args, device, common.torch_dtype(cfg.dtype))
    layout = ShardingLayout(attn_impl="flash", int8_kv_cache=args.int8_cache)
    res = greedy_serve(model, params, torch.as_tensor(prompt, device=device), args.new_tokens,
                       layout, **inputs)
    summary = {"event": "serve done", "arch": cfg.name, "device": str(device),
               "batch": args.batch, "prompt_len": args.prompt_len,
               "int8_cache": args.int8_cache,
               "prefill_ms": res.prefill_seconds * 1e3,
               "ms_per_token": res.decode_seconds / max(res.decode_steps, 1) * 1e3,
               "first_row": res.tokens[0].tolist()}
    print(json.dumps(summary), flush=True)
    return summary


def _dispatch(args) -> dict:
    if args.plan:
        return plan_main(args)
    if args.engine:
        raise SystemExit("--engine requires --plan")
    return host_main(args)


def main(argv: Optional[Sequence[str]] = None) -> dict:
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", required=True, choices=list_archs())
    ap.add_argument("--batch", type=int, default=4)
    ap.add_argument("--prompt-len", type=int, default=64)
    ap.add_argument("--new-tokens", type=int, default=8)
    ap.add_argument("--reduced", action=argparse.BooleanOptionalAction, default=True)
    ap.add_argument("--device", default="cuda")
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
    if args.trace:
        from repro_torch.obs.export import write_jsonl
        from repro_torch.obs.recorder import recording

        with recording() as rec:
            out = _dispatch(args)
        log.info("trace written", path=args.trace, events=write_jsonl(args.trace, rec.events))
        return out
    return _dispatch(args)


if __name__ == "__main__":
    main()
