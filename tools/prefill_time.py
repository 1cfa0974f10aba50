#!/usr/bin/env python3
"""Time the serve launcher's batched prefill of a full-width model on one card.

    python3 tools/prefill_time.py --arch hymba-1.5b [--tree DIR] [--reps 3] [--serve N]

The port is imported from ``DIR/src`` (default: this checkout), so that
two checkouts can be timed in one run on one card, in turns (A, B, B, A).
The model gets random bf16 weights from seed 0 and 8 prompts of 4096
tokens from ``RandomState(0)``, as ``chip_smoke.py`` serves them. After
one warm-up, ``--reps`` prefills (the step ``greedy_serve`` builds, and the
first argmax) are each timed by the host clock up to a device sync; one
more runs under torch.profiler for the device's busy time and the port's
kernels' device time. With ``--serve N``, N more runs of the serve
launcher's ``greedy_serve`` (after one warm-up) give its prefill seconds
and decode ms a step (32 new tokens: 31 decode steps). Prints one JSON
line, then the card's name and power limit.
"""
from __future__ import annotations

import argparse
import json
from pathlib import Path
import subprocess
import sys
import time


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--arch", required=True, help="hymba-1.5b or xlstm-350m")
    ap.add_argument("--tree", default=str(Path(__file__).resolve().parents[1]),
                    help="checkout whose src/repro_torch is timed")
    ap.add_argument("--reps", type=int, default=3)
    ap.add_argument("--serve", type=int, default=0,
                    help="also time this many greedy_serve runs (prefill and decode)")
    args = ap.parse_args()
    sys.path.insert(0, str(Path(args.tree).resolve() / "src"))
    import numpy as np
    import torch
    from torch.profiler import ProfilerActivity, profile

    from repro_torch.config import ShardingLayout, get_arch
    from repro_torch.kernels import _build
    from repro_torch.models import build_model
    from repro_torch.train.steps import build_prefill_step

    if not torch.cuda.is_available():
        print("prefill_time: no CUDA device", file=sys.stderr)
        return 2
    torch.backends.cuda.matmul.allow_tf32 = False
    _build.load()
    cfg = get_arch(args.arch)
    model = build_model(cfg)
    params = model.init(torch.Generator(device="cuda").manual_seed(0), "cuda", torch.bfloat16)
    B, S, new = 8, 4096, 32
    tokens = torch.as_tensor(np.random.RandomState(0).randint(0, cfg.vocab_size, (B, S))
                             .astype(np.int32), device="cuda")
    prefill = build_prefill_step(model, ShardingLayout(attn_impl="flash"), S + new)

    def once() -> float:
        t0 = time.perf_counter()
        logits, _ = prefill(params, {"tokens": tokens})
        logits[:, -1].argmax(-1)
        torch.cuda.synchronize()
        return time.perf_counter() - t0

    once()
    seconds = [once() for _ in range(args.reps)]
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        once()
    dev = [e for e in prof.key_averages() if getattr(e, "self_device_time_total", 0) > 0]
    # csrc/*.cu keep their kernels in an anonymous namespace
    port = {e.key.split("(anonymous namespace)::", 1)[1].split("(")[0]:
            e.self_device_time_total / 1e3 for e in dev if "(anonymous namespace)::" in e.key}
    out = {"arch": cfg.name, "tree": args.tree, "prefill_s": seconds,
           "device_busy_ms": sum(e.self_device_time_total for e in dev) / 1e3,
           "port_kernels_ms": port}
    if args.serve:
        from repro_torch.launch.serve import greedy_serve

        greedy_serve(model, params, tokens, new)
        runs = [greedy_serve(model, params, tokens, new) for _ in range(args.serve)]
        out["serve_prefill_s"] = [r.prefill_seconds for r in runs]
        out["decode_ms_per_step"] = [1e3 * r.decode_seconds / r.decode_steps for r in runs]
    print(json.dumps(out))
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True).stdout.strip())
    return 0


if __name__ == "__main__":
    sys.exit(main())
