#!/usr/bin/env python3
"""Time text-patched variants of the port's selective scan on one card.

    python3 tools/scan_variants.py [--reps 2]

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

Needs a CUDA device and nvcc, as the port's build does; prints one line
per variant and round, then the card's name and power limit.
"""
from __future__ import annotations

import argparse
import ctypes
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


def build(out: Path) -> dict:
    """Compile every variant (in parallel); return {name: loaded library}."""
    from repro_torch.kernels import _build

    src = (_build.CSRC / "ssm_scan.cu").read_text()
    procs = {}
    for name, patches in VARIANTS.items():
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
            raise RuntimeError(f"variant {name} did not build:\n{log}")
        lib = ctypes.CDLL(str(out / name / "lib.so"))
        lib.repro_ssm_scan.argtypes = _build.SIGNATURES["repro_ssm_scan"]
        lib.repro_ssm_scan.restype = ctypes.c_int
        lib.repro_error_string.argtypes = [ctypes.c_int]
        lib.repro_error_string.restype = ctypes.c_char_p
        libs[name] = lib
    return libs


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--reps", type=int, default=2, help="rounds over the variants")
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
    libs = build(_build.BUILD_DIR / "scan_variants")
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
