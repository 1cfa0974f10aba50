"""Training launcher of the port.

    python -m repro_torch.launch.train --arch <id> [--steps N]
        [--reduced | --no-reduced] [--device cuda|cpu] [--ckpt-dir DIR]
        [--spot-mode none|siwoft|checkpoint|hybrid] [--trace PATH]

Trains on one device (``cuda`` unless ``--device cpu``), attending through
the flash kernels' autograd Function: the CUDA kernels on the card, their
plain versions on the CPU. ``--reduced`` (the default, as in the
reference) runs the family-preserving tiny config; ``--no-reduced`` the
full one. With ``--spot-mode none`` the run is one ``run_segment``; with
``siwoft|checkpoint|hybrid`` it goes through the provisioner
(``SpotTrainingOrchestrator``) as the reference's launcher drives it: the
market set of ``generate_markets(seed=3)`` (90 days of history, 30 of
future), segments of ``steps // 5``. ``--trace`` records the event
timeline to a JSONL file that ``python -m repro.obs.replay`` replays.
"""
import argparse
import json
import tempfile

import torch

from repro_torch import resolve_device
from repro_torch.ckpt import CheckpointManager
from repro_torch.config import ShardingLayout, TrainConfig, get_arch, list_archs
from repro_torch.core import generate_markets, split_history_future
from repro_torch.core.orchestrator import SpotTrainingOrchestrator
from repro_torch.data import SyntheticLM
from repro_torch.models import build_model
from repro_torch.obs import recording, write_jsonl
from repro_torch.train.loop import run_segment
from repro_torch.train.steps import init_train_state


def _run(args) -> dict:
    device = resolve_device(args.device)
    cfg = get_arch(args.arch)
    if args.reduced:
        cfg = cfg.reduced()
    model = build_model(cfg)
    ds = SyntheticLM(cfg.vocab_size, args.seq, args.batch, seed=args.seed)
    tc = TrainConfig(total_steps=args.steps, warmup_steps=min(20, args.steps // 10 + 1))
    layout = ShardingLayout(attn_impl="flash")
    print(json.dumps({"event": "launching", "arch": cfg.name, "device": str(device),
                      "params_m": model.param_count() / 1e6, "mode": args.spot_mode}),
          flush=True)
    if args.spot_mode != "none":
        return _run_spot(args, model, ds, tc, layout, device)
    ckpt = CheckpointManager(args.ckpt_dir, keep=3) if args.ckpt_dir else None
    state = init_train_state(model, torch.Generator(device=device).manual_seed(args.seed), device)
    try:
        res = run_segment(
            model, state, ds, device, tc, layout,
            num_steps=args.steps, ckpt=ckpt, ckpt_every=50,
        )
    finally:
        if ckpt:
            ckpt.close()
    summary = {"event": "training done", "loss_first": res.losses[0],
               "loss_last": res.losses[-1],
               "mean_step_ms": sum(res.step_seconds) / len(res.step_seconds) * 1e3}
    print(json.dumps(summary), flush=True)
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
    print(json.dumps(summary), flush=True)
    return summary


def main(argv=None) -> dict:
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="qwen3-4b", choices=list_archs())
    ap.add_argument("--steps", type=int, default=100)
    ap.add_argument("--batch", type=int, default=4)
    ap.add_argument("--seq", type=int, default=64)
    ap.add_argument("--reduced", action=argparse.BooleanOptionalAction, default=True)
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--spot-mode", default="none",
                    choices=["none", "siwoft", "checkpoint", "hybrid"])
    ap.add_argument("--ckpt-dir", default="")
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--trace", default="",
                    help="record the structured event timeline to this JSONL path "
                         "(replay with python -m repro.obs.replay)")
    args = ap.parse_args(argv)
    if not args.trace:
        return _run(args)
    with recording() as rec:
        summary = _run(args)
    n = write_jsonl(args.trace, rec.events)
    print(json.dumps({"event": "trace written", "path": args.trace, "events": n}), flush=True)
    return summary


if __name__ == "__main__":
    main()
