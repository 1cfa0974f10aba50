"""Training launcher of the port.

    python -m repro_torch.launch.train --arch <id> [--steps N]
        [--reduced | --no-reduced] [--device cuda|cpu] [--devices N]
        [--ckpt-dir DIR] [--spot-mode none|siwoft|checkpoint|hybrid] [--trace PATH]

Trains over ``--devices`` ranks, one process and one device each (by
default every local card, as the reference's ``make_host_mesh()`` takes
every local device; one on the CPU): ``cuda`` with NCCL unless ``--device
cpu``, which spawns N gloo ranks. It never falls back to the CPU when the
cards are missing. With more than one rank the state is sharded over a
plan of every rank (``train.steps.build_sharded_train_step``), or, under a
spot mode, the provisioner moves it between plans of the world's ranks;
rank 0 prints and writes the trace. Each rank attends through
the flash kernels' autograd Function (a hybrid model's Mamba blocks
scanning through the selective scan's, an xLSTM's mLSTM blocks through
the mLSTM's): the CUDA kernels on the card, their plain versions on the
CPU. An encoder-decoder (whisper) and a VLM (internvl2-26b) are refused:
the data path makes no frames and no patches (train them through
``train.steps.build_train_step`` with a batch that carries them).
``--reduced`` (the default, as in the reference) runs the
family-preserving tiny config; ``--no-reduced`` the full one. With
``--spot-mode none`` the run is one ``run_segment``; with
``siwoft|checkpoint|hybrid`` it goes through the provisioner
(``SpotTrainingOrchestrator``) as the reference's launcher drives it: the
market set of ``generate_markets(seed=3)`` (90 days of history, 30 of
future), segments of ``steps // 5``. ``--trace`` records the event
timeline to a JSONL file that ``python -m repro.obs.replay`` replays.
"""
import argparse
import json
import os
import tempfile

import torch

from repro_torch import resolve_device
from repro_torch.ckpt import CheckpointManager
from repro_torch.config import ShardingLayout, TrainConfig, get_arch, list_archs
from repro_torch.core import generate_markets, split_history_future
from repro_torch.core.orchestrator import SpotTrainingOrchestrator
from repro_torch.data import SyntheticLM
from repro_torch.dist import ElasticMeshManager, elastic, reshard_tree
from repro_torch.launch.mesh import local_world_size, run_world, world
from repro_torch.models import build_model
from repro_torch.obs import recording, write_jsonl
from repro_torch.train.loop import make_step, run_segment, state_shardings
from repro_torch.train.steps import init_train_state


def _say(obj: dict) -> None:
    if world() is None or world().rank == 0:
        print(json.dumps(obj), flush=True)


def _run(args) -> dict:
    w = world()
    device = w.device if w is not None else resolve_device(args.device)
    cfg = get_arch(args.arch)
    if args.reduced:
        cfg = cfg.reduced()
    needs = "frames" if cfg.encoder_layers else "patches" if cfg.vision_tokens else ""
    if needs:
        raise SystemExit(f"launch.train: {cfg.name} trains on {needs}, which the data path does "
                         f"not make (neither does the reference's); train it through "
                         f"build_train_step with a batch that carries {needs}")
    model = build_model(cfg)
    ds = SyntheticLM(cfg.vocab_size, args.seq, args.batch, seed=args.seed)
    tc = TrainConfig(total_steps=args.steps, warmup_steps=min(20, args.steps // 10 + 1))
    layout = ShardingLayout(attn_impl="flash")
    _say({"event": "launching", "arch": cfg.name, "device": str(device),
          "ranks": w.size if w is not None else 1,
          "params_m": model.param_count() / 1e6, "mode": args.spot_mode})
    if args.spot_mode != "none":
        return _run_spot(args, model, ds, tc, layout, device)
    ckpt = CheckpointManager(args.ckpt_dir, keep=3) if args.ckpt_dir else None
    state = init_train_state(model, torch.Generator(device=device).manual_seed(args.seed), device)
    mesh = jitted = None
    if w is not None:
        mesh = ElasticMeshManager().plan_for(w.size).mesh
        state = reshard_tree(state, state_shardings(model, mesh, layout), elastic.everywhere(state))
        jitted = make_step(model, tc, layout, mesh)
    try:
        res = run_segment(
            model, state, ds, device, tc, layout,
            num_steps=args.steps, ckpt=ckpt, ckpt_every=50, jitted=jitted, mesh=mesh,
        )
    finally:
        if ckpt:
            ckpt.close()
    summary = {"event": "training done", "loss_first": res.losses[0],
               "loss_last": res.losses[-1],
               "mean_step_ms": sum(res.step_seconds) / len(res.step_seconds) * 1e3}
    _say(summary)
    return summary


def _run_spot(args, model, ds, tc, layout, device) -> dict:
    ms = generate_markets(seed=3, n_hours=24 * 90 + 24 * 30)
    hist, fut = split_history_future(ms, 24 * 90)
    with tempfile.TemporaryDirectory() as d:
        orch = SpotTrainingOrchestrator(
            model, ds, device, hist, fut, mode=args.spot_mode, tc=tc, layout=layout,
            segment_steps=max(args.steps // 5, 1), steps_per_trace_hour=200,
            ckpt_dir=args.ckpt_dir or d, ckpt_every=10, seed=args.seed,
        )
        try:
            rep = orch.run(args.steps)
        finally:
            if orch.ckpt is not None:
                orch.ckpt.close()
    summary = {"event": "spot training done", "useful": rep.useful_steps,
               "wasted": rep.wasted_steps, "revocations": rep.revocations,
               "goodput": rep.goodput, "cost_dollars": rep.cost_dollars,
               "loss_first": rep.losses[0], "loss_last": rep.losses[-1]}
    if rep.moves:
        summary["moves"] = rep.moves
    _say(summary)
    return summary


def _main(args) -> dict:
    if not args.trace:
        return _run(args)
    with recording() as rec:
        summary = _run(args)
    if world() is None or world().rank == 0:
        n = write_jsonl(args.trace, rec.events)
        _say({"event": "trace written", "path": args.trace, "events": n})
    return summary


def _rank(w, args) -> dict:
    return _main(args)


def main(argv=None) -> dict:
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="qwen3-4b", choices=list_archs())
    ap.add_argument("--steps", type=int, default=100)
    ap.add_argument("--batch", type=int, default=4)
    ap.add_argument("--seq", type=int, default=64)
    ap.add_argument("--reduced", action=argparse.BooleanOptionalAction, default=True)
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--devices", type=int, default=0,
                    help="ranks, one device each (default: every local card; 1 on the CPU)")
    ap.add_argument("--spot-mode", default="none",
                    choices=["none", "siwoft", "checkpoint", "hybrid"])
    ap.add_argument("--ckpt-dir", default="")
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--trace", default="",
                    help="record the structured event timeline to this JSONL path "
                         "(replay with python -m repro.obs.replay)")
    args = ap.parse_args(argv)
    n = args.devices or local_world_size(args.device)
    if n > 1:
        threads = max(1, (os.cpu_count() or 1) // n) if args.device == "cpu" else 0
        return run_world(_rank, n, args.device, (args,), timeout=None, threads=threads)
    return _main(args)


if __name__ == "__main__":
    main()
