#!/usr/bin/env python3
"""Time text-patched variants of the port's selective scan on one card.

    python3 tools/scan_variants.py [--reps 2]
    python3 tools/scan_variants.py --backward [--reps 2] [--only kept,lb2]

Each variant is ``src/repro_torch/csrc/ssm_scan.cu`` with a few lines
replaced, compiled on its own (one nvcc each, in parallel) and called
through the port's wrapper at hymba-1.5b's serving shapes (prefill B8
S4096 inner3200 N16 and one decode step, u bf16, dt/B_/C_ f32, h0
carried; ``chip_smoke.py``'s inputs). For each: device time per launch
(torch.profiler, L2 flushed before each launch), CUDA-event time, and the
largest errors of y and h against ``ssm_scan_ref`` (a variant that drops
arithmetic is wrong by design; its time says what the rest costs). The
variants:

* ``kept``: the source as it is;
* ``expf``: ``expf(dt * A)`` in place of ``ex2.approx`` of a pre-scaled A;
* ``guarded``: every tile takes the per-step guarded path of a ragged
  last tile (a branch between steps);
* ``no-chunks``: without the branch that keeps the state after each tile
  for the backward (never taken at these shapes, where the wrapper keeps
  none): the forward as it was before that output;
* ``no-exp``: the decay is dt * A itself, no exponential;
* ``no-recurrence``: tiles are staged, reduced and stored, but no step is
  computed.

With ``--backward``, the scan's backward instead, at hymba-1.5b's training
microbatch (B1 S4096 inner3200 N16, u bf16, no h0 or dh; ``chip_smoke.py``'s
inputs): per variant and segment length its time (CUDA events, L2 flushed
before each call; min, median and max over the calls), device time per
kernel (torch.profiler) and largest errors against ``ssm_scan_bwd_ref``.
The variants (``BWD_VARIANTS``):

* ``kept``: the source as it is;
* ``bc-shuffle``: the per-step channel sums of dB_ and dC_ shuffled over
  the whole warp, one partial a warp into shared memory (the source stops
  the shuffles at each half warp and leaves two partials a warp to the sum
  after the tile; a whole tile of every channel's sums would not fit the
  48 KB of static shared memory);
* ``lb2``: the main pass's registers not capped (ptxas gives it 128, two
  blocks an SM, where the source caps them for three: 80);
* ``bspl4``: 4 states a thread in both passes and 128 threads a block (the
  same channels a block; fewer shuffles of du and ddt a state; the cap for
  3 blocks an SM then spills); ``bspl4-lb2``: the same, capped for 2;

each at the segment length the wrapper picks (``kernel.bwd_segment``: 384
steps there) and at ``SEGMENTS``' (4096: one segment, no carry pass, the
walk of one block a row over all 4096 steps).

Needs a CUDA device and nvcc, as the port's build does; prints one line
per variant and round, then the card's name and power limit.
"""
from __future__ import annotations

import argparse
import ctypes
import re
import shutil
import subprocess
import sys
from pathlib import Path

REPO = Path(__file__).resolve().parents[1]

VARIANTS = {
    "kept": [],
    "expf": [("exp2_approx(dtt[c] * a[c][j])", "expf(dtt[c] * a[c][j])"),
             ("exp2_approx(dtt * a[j])", "expf(dtt * a[j])"), (" * LOG2E", "")],
    "guarded": [("if (steps == TS) {", "if (false) {")],
    "no-chunks": [("if (h_chunks != nullptr && k + 1 < tiles) {", "if (false) {")],
    "no-exp": [("exp2_approx(dtt[c] * a[c][j])", "(dtt[c] * a[c][j])")],
    "no-recurrence": [("auto advance = [&](int t) {   // the recurrence of step t",
                       "auto advance = [&](int t) { p[t][0] = p[t][1] = um[t] = 0.f; };\n"
                       "    auto unused = [&](int t) {")],
}
# the backward's variants (--backward)
LB3 = "__global__ void __launch_bounds__(BWD_THREADS, 3) ssm_scan_bwd_kernel("
BWD_VARIANTS = {
    "kept": [],
    "bc-shuffle": [
        ("  float red[2][2 * WARPS][TS][N];", "  float red[2][WARPS][TS][N];"),
        ("      for (int off = LANES; off < 16; off *= 2) {",
         "      for (int off = LANES; off < 32; off *= 2) {"),
        ("      if (threadIdx.x % 16 < LANES) {", "      if (threadIdx.x % 32 < LANES) {"),
        ("sm.red[0][2 * warp + threadIdx.x % 32 / 16][t]", "sm.red[0][warp][t]"),
        ("sm.red[1][2 * warp + threadIdx.x % 32 / 16][t]", "sm.red[1][warp][t]"),
        ("for (int w = 0; w < 2 * WARPS; ++w) s += sm.red[which][w][r][n];",
         "for (int w = 0; w < WARPS; ++w) s += sm.red[which][w][r][n];")],
    "lb2": [(LB3, "__global__ void __launch_bounds__(BWD_THREADS) ssm_scan_bwd_kernel(")],
    "bspl4": [("constexpr int BSPL = 2;", "constexpr int BSPL = 4;"),
              ("constexpr int BWD_THREADS = 256;", "constexpr int BWD_THREADS = 128;")],
    "bspl4-lb2": [("constexpr int BSPL = 2;", "constexpr int BSPL = 4;"),
                  ("constexpr int BWD_THREADS = 256;", "constexpr int BWD_THREADS = 128;"),
                  (LB3, "__global__ void __launch_bounds__(BWD_THREADS, 2) ssm_scan_bwd_kernel(")],
}
SEGMENTS = (128, 256, 768, 4096)   # timesteps of a backward segment, beside the wrapper's


def build(out: Path, variants: dict, entry: str) -> dict:
    """Compile every variant (in parallel); return {name: loaded library}."""
    from repro_torch.kernels import _build

    src = (_build.CSRC / "ssm_scan.cu").read_text()
    procs = {}
    for name, patches in variants.items():
        d = out / name
        d.mkdir(parents=True, exist_ok=True)
        text = src
        for old, new in patches:
            if old not in text:
                raise RuntimeError(f"variant {name}: {old!r} is not in ssm_scan.cu")
            text = text.replace(old, new)
        (d / "ssm_scan.cu").write_text(text)
        for f in ("common.cuh", "errors.cu"):
            shutil.copy(_build.CSRC / f, d / f)
        cmd = [_build.nvcc_path(), *_build.NVCC_FLAGS, "-shared", "-o", str(d / "lib.so"),
               str(d / "ssm_scan.cu"), str(d / "errors.cu")]
        procs[name] = subprocess.Popen(cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
                                       text=True)
    libs = {}
    for name, proc in procs.items():
        log, _ = proc.communicate()
        if proc.returncode:
            print(f"[scan_variants] {name} did not build:\n{log[-3000:]}", flush=True)
            continue
        regs = [(e.split("'", 1)[0][-40:], re.search(r"Used (\d+) registers", e).group(1),
                 re.search(r"(\d+) bytes spill stores", e).group(1))
                for e in log.split("Compiling entry function '")[1:] if "_bwd" in e[:200]]
        print(f"[scan_variants] {name} built; ptxas of the backward (kernel, registers, spill "
              f"stores): {regs}", flush=True)
        lib = ctypes.CDLL(str(out / name / "lib.so"))
        getattr(lib, entry).argtypes = _build.SIGNATURES[entry]
        getattr(lib, entry).restype = ctypes.c_int
        lib.repro_error_string.argtypes = [ctypes.c_int]
        lib.repro_error_string.restype = ctypes.c_char_p
        libs[name] = lib
    return libs


def backward(reps: int, only: str = "") -> None:
    """The backward's variants and segment lengths at the training shape."""
    import torch

    import chip_smoke as cs
    from repro_torch.kernels import _build
    from repro_torch.kernels.ssm_scan import kernel
    from repro_torch.kernels.ssm_scan.ref import ssm_scan_bwd_ref

    names = only.split(",") if only else list(BWD_VARIANTS)
    libs = build(_build.BUILD_DIR / "scan_bwd_variants", {n: BWD_VARIANTS[n] for n in names},
                 "repro_ssm_scan_bwd")
    _build.load()                      # the forward kernel that keeps the states
    gen = torch.Generator(device="cuda").manual_seed(0)
    flush = torch.empty(256 * 2**20, dtype=torch.uint8, device="cuda")
    sh = cs.HYMBA_TRAIN_SCAN
    B, S, inner, N = sh["B"], sh["S"], sh["inner"], sh["N"]
    u, dt, B_, C_, A, D, _ = cs._ssm_inputs(gen, B, S, inner, N, torch.bfloat16, torch.float32)
    dy = torch.randn((B, S, inner), generator=gen, device="cuda").to(torch.bfloat16)
    _, _, chunks = kernel.ssm_scan(u, dt, B_, C_, A, D, None, keep_chunks=True)
    args = (u, dt, B_, C_, A, D, None, chunks, dy, None)
    want = ssm_scan_bwd_ref(u, dt, B_, C_, A, D, None, dy, None)
    rule = kernel.bwd_segment
    segs = (rule(B, S, inner, N), *SEGMENTS)
    for rnd in range(reps):
        for name, lib in libs.items():
            _build._lib = lib          # the port's wrapper launches this variant
            for seg in segs:
                kernel.bwd_segment = lambda *shape, seg=seg: seg
                got = kernel.ssm_scan_bwd(*args)
                torch.cuda.synchronize()
                err = max(float((a.float() - b.float()).abs().max())
                          for a, b in zip(got, want) if a is not None)
                t = cs.time_each(lambda: kernel.ssm_scan_bwd(*args), flush, reps=20)
                dev = cs._device_ms_per_launch(lambda: kernel.ssm_scan_bwd(*args), flush, "ssm_")
                print(f"[scan_variants] backward {name}, segments of {seg} steps "
                      f"({kernel.bwd_segments(S, seg)}; round {rnd}): {cs.fmt_spread(t)}, device "
                      f"{dev}, max err {err:.3e}", flush=True)
    kernel.bwd_segment = rule


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--reps", type=int, default=2, help="rounds over the variants")
    ap.add_argument("--backward", action="store_true",
                    help="the backward's variants at hymba's training shape")
    ap.add_argument("--only", default="", help="comma-separated backward variants (default: all)")
    args = ap.parse_args()
    sys.path[:0] = [str(REPO / "src"), str(REPO)]
    import torch

    import chip_smoke as cs
    from repro_torch.kernels import _build
    from repro_torch.kernels.ssm_scan import kernel
    from repro_torch.kernels.ssm_scan.ref import ssm_scan_ref

    if not torch.cuda.is_available():
        print("scan_variants: no CUDA device", file=sys.stderr)
        return 2
    if args.backward:
        backward(args.reps, args.only)
        print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                              "--format=csv,noheader"], capture_output=True, text=True).stdout.strip())
        return 0
    libs = build(_build.BUILD_DIR / "scan_variants", VARIANTS, "repro_ssm_scan")
    gen = torch.Generator(device="cuda").manual_seed(0)
    flush = torch.empty(256 * 2**20, dtype=torch.uint8, device="cuda")
    shapes = {"prefill": (8, 4096), "decode": (8, 1)}
    inputs = {k: cs._ssm_inputs(gen, B, S, 3200, 16, torch.bfloat16, torch.float32)
              for k, (B, S) in shapes.items()}
    refs = {k: ssm_scan_ref(*a) for k, a in inputs.items()}
    for rnd in range(args.reps):
        for name, lib in libs.items():
            _build._lib = lib          # the port's wrapper launches this variant
            line = []
            for k, a in inputs.items():
                y, h = kernel.ssm_scan(*a)
                torch.cuda.synchronize()
                ey = float((y.float() - refs[k][0].float()).abs().max())
                eh = float((h - refs[k][1]).abs().max())
                ev = cs.time_ms(lambda: kernel.ssm_scan(*a), flush)
                dev = cs._device_ms_per_launch(lambda: kernel.ssm_scan(*a), flush, "ssm_")
                line.append(f"{k} {ev:.4f} ms by events, device {dev}, max err y {ey:.3e} "
                            f"h {eh:.3e}")
            print(f"[scan_variants] {name} (round {rnd}): " + "; ".join(line), flush=True)
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True).stdout.strip())
    return 0


if __name__ == "__main__":
    sys.exit(main())
