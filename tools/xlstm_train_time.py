#!/usr/bin/env python3
"""Time full-width xlstm-350m training steps on one card.

    python3 tools/xlstm_train_time.py [--tree DIR] [--steps 6]

The port is imported from ``DIR/src`` (default: this checkout), so that
two checkouts can be timed in one call on one card, in turns (A, B, B, A,
one process each). The step is ``chip_smoke.py``'s phase 15: f32 params
and AdamW from seed 0, sequence 4096, global batch 2 in 2 microbatches,
remat per group, ``SyntheticLM`` data from seed 0, through ``run_segment``.
After one step that includes the first calls' set-up, ``--steps`` steps are
each timed by the host clock up to the loss's read (a device sync); one
more runs under torch.profiler for the device's busy time and the device
time of the sLSTM's kernels, the tensor-core mLSTM forward's (all its
kernels) and the mLSTM backward's. Prints one JSON line, then the card's name and power limit.
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
    ap.add_argument("--tree", default=str(Path(__file__).resolve().parents[1]),
                    help="checkout whose src/repro_torch is timed")
    ap.add_argument("--steps", type=int, default=6, help="timed steps after the first")
    args = ap.parse_args()
    sys.path.insert(0, str(Path(args.tree).resolve() / "src"))
    import torch
    from torch.profiler import ProfilerActivity, profile

    from repro_torch.config import ShardingLayout, TrainConfig, get_arch
    from repro_torch.data import SyntheticLM
    from repro_torch.kernels import _build
    from repro_torch.models import build_model
    from repro_torch.train.loop import make_step, run_segment
    from repro_torch.train.steps import init_train_state

    if not torch.cuda.is_available():
        print("xlstm_train_time: no CUDA device", file=sys.stderr)
        return 2
    torch.backends.cuda.matmul.allow_tf32 = False
    _build.load()
    cfg = get_arch("xlstm-350m")
    model = build_model(cfg)
    tc = TrainConfig(total_steps=args.steps + 1, warmup_steps=1, microbatches=2)
    layout = ShardingLayout(attn_impl="flash")
    ds = SyntheticLM(cfg.vocab_size, 4096, 2, seed=0)
    state = init_train_state(model, torch.Generator(device="cuda").manual_seed(0), "cuda")
    step_fn = make_step(model, tc, layout)
    res = run_segment(model, state, ds, "cuda", tc, layout, num_steps=args.steps + 1,
                      jitted=step_fn)
    ms = sorted(1e3 * s for s in res.step_seconds[1:])
    batch = {k: torch.from_numpy(v).to("cuda") for k, v in ds.batch(res.state.step).items()}
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        step_fn(res.state, batch)
        torch.cuda.synchronize()
        window = (time.perf_counter() - t0) * 1e3
    dev = [e for e in prof.key_averages() if getattr(e, "self_device_time_total", 0) > 0
           and str(getattr(e, "device_type", "")).endswith("CUDA")]
    kern = lambda key: sum(e.self_device_time_total for e in dev if key in e.key) / 1e3
    print(json.dumps({
        "tree": str(Path(args.tree).resolve()), "step_ms": ms,
        "min_median_max_ms": [ms[0], ms[len(ms) // 2], ms[-1]],
        "profiled_window_ms": window,
        "device_busy_ms": sum(e.self_device_time_total for e in dev) / 1e3,
        "slstm_fwd_ms": kern("slstm_fwd_kernel"), "slstm_bwd_ms": kern("slstm_bwd_kernel"),
        "mlstm_tc_ms": kern("mlstm_tc"), "mlstm_bwd_ms": kern("mlstm_bwd")}))
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True).stdout.strip())
    return 0


if __name__ == "__main__":
    sys.exit(main())
