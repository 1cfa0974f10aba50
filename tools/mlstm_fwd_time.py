#!/usr/bin/env python3
"""Time the chunkwise mLSTM forward kernels on one card.

    python3 tools/mlstm_fwd_time.py [--tree DIR] [--reps 20] [--batch 8 [1 ...]] [--tc-only]

The port is imported from ``DIR/src`` (default: this checkout), so that
two checkouts can be timed in one call on one card, in turns (A, B, B, A).
At xlstm-350m's prefill shape (B8 S4096 H4 hd512; ``--batch 1`` gives its
training step's B1, several values one shape after another; inputs from a
seeded ``torch.Generator("cuda")``), ``mlstm_tc`` (bf16) is timed in each
of its designs where the tree has them (``kernel.tc_call``: "split" and
"single"; an older tree's one kernel as "single"), and ``mlstm_tf32`` (f32
and bf16) unless ``--tc-only``: CUDA events around each of ``--reps``
calls, the L2 flushed before each, after two warm-up calls; where the
tree's wrappers take ``keep`` (what the gradient starts from), the keeping
calls too. Each tensor-core call's device time by kernel (the split's
carry and output passes) comes from torch.profiler over 5 calls. Prints
one JSON line a shape: min / median / max ms by call, device ms by kernel,
the bf16 bound (``kernels/mlstm/ops.py::cost`` over the H100's 989 TFLOP/s
and 3.35 TB/s), the kept states' floor (their bytes written once at 3.35
TB/s) and the design the tree's wrapper takes; then the card's name and
power limit.
"""
from __future__ import annotations

import argparse
import functools
import json
from pathlib import Path
import re
import subprocess
import sys


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--tree", default=str(Path(__file__).resolve().parents[1]),
                    help="checkout whose src/repro_torch is timed")
    ap.add_argument("--reps", type=int, default=20)
    ap.add_argument("--batch", type=int, nargs="+", default=[8])
    ap.add_argument("--tc-only", action="store_true", help="time the tensor-core kernel only")
    args = ap.parse_args()
    sys.path.insert(0, str(Path(args.tree).resolve() / "src"))
    import torch
    from torch.profiler import ProfilerActivity, profile

    from repro_torch.kernels import _build
    from repro_torch.kernels.mlstm import kernel
    from repro_torch.kernels.mlstm.ops import cost

    if not torch.cuda.is_available():
        print("mlstm_fwd_time: no CUDA device", file=sys.stderr)
        return 2
    _build.load()
    gen = torch.Generator(device="cuda").manual_seed(0)
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

    def device_ms(fn, reps: int = 5) -> dict:
        """Device ms a launch of each mLSTM kernel over ``reps`` calls."""
        fn()
        torch.cuda.synchronize()
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            for _ in range(reps):
                flush.zero_()
                fn()
            torch.cuda.synchronize()
        return {re.search(r"\w*mlstm\w*", e.key).group(): e.self_device_time_total / e.count / 1e3
                for e in prof.key_averages()
                if "mlstm" in e.key and getattr(e, "self_device_time_total", 0) > 0}

    keeps = "keep" in kernel.mlstm_tc.__code__.co_varnames
    for B in args.batch:
        S, H, hd = 4096, 4, 512
        rnd = lambda *shape: torch.randn(shape, generator=gen, device="cuda")
        qb, kb, vb = (rnd(B, S, H, hd).to(torch.bfloat16) for _ in range(3))
        gates = rnd(B, S, 2 * H) * 2.0
        if hasattr(kernel, "tc_call"):
            calls = {f"tc {d}": functools.partial(kernel.tc_call, d, qb, kb, vb, gates)
                     for d in ("split", "single")}
        else:
            calls = {"tc single": functools.partial(kernel.mlstm_tc, qb, kb, vb, gates)}
        if not args.tc_only:
            qf, kf, vf = (rnd(B, S, H, hd) for _ in range(3))
            calls["tf32 f32"] = functools.partial(kernel.mlstm_tf32, qf, kf, vf, gates)
            calls["tf32 bf16"] = functools.partial(kernel.mlstm_tf32, qb, kb, vb, gates)
        out, dev = {}, {}
        for name, fn in calls.items():
            for kp in (False, True) if keeps else (False,):
                key = name + (" keep" if kp else "")
                call = functools.partial(fn, keep=True) if kp else fn
                out[key] = spread(call)
                if name.startswith("tc"):
                    dev[key] = device_ms(call)
        flops, nbytes = cost(B, S, H, hd, el=2)
        bound = max(flops / 989e12, nbytes / 3.35e12) * 1e3
        nc = -(-S // 64)
        kept_bytes = 4.0 * B * H * nc * (hd * hd + hd + 1) + 4.0 * B * S * H
        pick = kernel.tc_design(B, S, H, hd) if hasattr(kernel, "tc_design") else "single"
        print(json.dumps({"tree": args.tree, "B": B, "S": S, "H": H, "hd": hd,
                          "ms_min_median_max": out, "device_ms_per_call": dev,
                          "bf16_bound_ms": bound,
                          "bound_by": "operations" if flops / 989e12 >= nbytes / 3.35e12
                          else "bytes", "kept_floor_ms": kept_bytes / 3.35e12 * 1e3,
                          "wrapper_takes": pick}), flush=True)
        del qb, kb, vb, gates, calls
        torch.cuda.empty_cache()
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True)
    print(smi.stdout.strip())
    return 0


if __name__ == "__main__":
    sys.exit(main())
