"""Training launcher of the port.

    python -m repro_torch.launch.train --arch <id> [--steps N]
        [--reduced | --no-reduced] [--device cuda|cpu] [--ckpt-dir DIR]
        [--spot-mode none]

Runs ``run_segment`` on one device (``cuda`` unless ``--device cpu``),
attending through the flash kernels' autograd Function: the CUDA kernels
on the card, their plain versions on the CPU. ``--reduced`` (the default,
as in the reference) runs the family-preserving tiny config;
``--no-reduced`` the full one. The orchestrator modes
(``siwoft|checkpoint|hybrid``) are not ported yet.
"""
import argparse
import json

import torch

from repro_torch import resolve_device
from repro_torch.ckpt import CheckpointManager
from repro_torch.config import ShardingLayout, TrainConfig, get_arch, list_archs
from repro_torch.data import SyntheticLM
from repro_torch.models import build_model
from repro_torch.train.loop import run_segment
from repro_torch.train.steps import init_train_state


def _run(args) -> dict:
    if args.spot_mode != "none":
        raise NotImplementedError(
            f"repro_torch: --spot-mode {args.spot_mode} needs the orchestrator, not ported yet")
    device = resolve_device(args.device)
    cfg = get_arch(args.arch)
    if args.reduced:
        cfg = cfg.reduced()
    model = build_model(cfg)
    ds = SyntheticLM(cfg.vocab_size, args.seq, args.batch, seed=args.seed)
    tc = TrainConfig(total_steps=args.steps, warmup_steps=min(20, args.steps // 10 + 1))
    print(json.dumps({"event": "launching", "arch": cfg.name, "device": str(device),
                      "params_m": model.param_count() / 1e6}), flush=True)
    ckpt = CheckpointManager(args.ckpt_dir, keep=3) if args.ckpt_dir else None
    state = init_train_state(model, torch.Generator(device=device).manual_seed(args.seed), device)
    try:
        res = run_segment(
            model, state, ds, device, tc, ShardingLayout(attn_impl="flash"),
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


def main() -> None:
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
    _run(ap.parse_args())


if __name__ == "__main__":
    main()
