#!/usr/bin/env python3
"""Time the chunkwise mLSTM forward kernels on one card.

    python3 tools/mlstm_fwd_time.py [--tree DIR] [--reps 20] [--batch 8]

The port is imported from ``DIR/src`` (default: this checkout), so that
two checkouts can be timed in one call on one card, in turns (A, B, B, A).
At xlstm-350m's prefill shape (B8 S4096 H4 hd512; ``--batch 1`` gives its
training step's B1, inputs from a seeded ``torch.Generator("cuda")``), each of ``mlstm_tc`` (bf16) and
``mlstm_tf32`` (f32 and bf16) is timed by CUDA events around each of
``--reps`` calls, the L2 flushed before each, after two warm-up calls;
where the tree's wrappers take ``keep`` (what the gradient starts from),
the keeping calls are timed too. Prints one JSON line of min / median /
max ms by call with the bf16 bound (``kernels/mlstm/ops.py::cost`` over
the H100's 989 TFLOP/s and 3.35 TB/s), then the card's name and power
limit.
"""
from __future__ import annotations

import argparse
import json
from pathlib import Path
import subprocess
import sys


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--tree", default=str(Path(__file__).resolve().parents[1]),
                    help="checkout whose src/repro_torch is timed")
    ap.add_argument("--reps", type=int, default=20)
    ap.add_argument("--batch", type=int, default=8)
    args = ap.parse_args()
    sys.path.insert(0, str(Path(args.tree).resolve() / "src"))
    import torch

    from repro_torch.kernels import _build
    from repro_torch.kernels.mlstm import kernel

    if not torch.cuda.is_available():
        print("mlstm_fwd_time: no CUDA device", file=sys.stderr)
        return 2
    _build.load()
    gen = torch.Generator(device="cuda").manual_seed(0)
    B, S, H, hd = args.batch, 4096, 4, 512
    rnd = lambda *shape: torch.randn(shape, generator=gen, device="cuda")
    flush = torch.empty(256 * 2**20, dtype=torch.uint8, device="cuda")

    def spread(fn) -> list:
        for _ in range(2):
            fn()
        torch.cuda.synchronize()
        pairs = []
        for _ in range(args.reps):
            flush.zero_()
            start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
            start.record()
            fn()
            end.record()
            pairs.append((start, end))
        torch.cuda.synchronize()
        xs = sorted(s.elapsed_time(e) for s, e in pairs)
        return [xs[0], xs[len(xs) // 2], xs[-1]]

    qb, kb, vb = (rnd(B, S, H, hd).to(torch.bfloat16) for _ in range(3))
    qf, kf, vf = (rnd(B, S, H, hd) for _ in range(3))
    gates = rnd(B, S, 2 * H) * 2.0
    calls = {"tc": lambda **kw: kernel.mlstm_tc(qb, kb, vb, gates, **kw),
             "tf32 f32": lambda **kw: kernel.mlstm_tf32(qf, kf, vf, gates, **kw),
             "tf32 bf16": lambda **kw: kernel.mlstm_tf32(qb, kb, vb, gates, **kw)}
    keeps = "keep" in kernel.mlstm_tc.__code__.co_varnames
    out = {}
    for name, fn in calls.items():
        out[name] = spread(fn)
        if keeps:
            out[name + " keep"] = spread(lambda: fn(keep=True))
    from repro_torch.kernels.mlstm.ops import cost

    flops, nbytes = cost(B, S, H, hd, el=2)
    bound = max(flops / 989e12, nbytes / 3.35e12) * 1e3
    print(json.dumps({"tree": args.tree, "B": B, "S": S, "H": H, "hd": hd,
                      "ms_min_median_max": out, "bf16_bound_ms": bound,
                      "bound_by": "operations" if flops / 989e12 >= nbytes / 3.35e12
                      else "bytes"}))
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True)
    print(smi.stdout.strip())
    return 0


if __name__ == "__main__":
    sys.exit(main())
