#!/usr/bin/env python3
"""Time the port's chunkwise mLSTM backward, its kernels and text-patched variants on one card.

    python3 tools/mlstm_bwd_variants.py [--tree build/parent] [--rounds 2] [--only kept]

Each variant is ``csrc/mlstm_bwd.cu`` (and the split-TF32 helpers it
includes, ``csrc/tf32.cuh``) with a few lines replaced, compiled on its own
(one nvcc each, in parallel, by ``tools/flash_bwd_variants.py``'s
``build``, which prints each build's ptxas registers and spill stores) and
called through the port's wrapper ``kernel.mlstm_bwd`` at xlstm-350m's
training microbatch (B1 S4096 H4 hd512), q, k, v in bf16 (the path's) and
in f32, on what the forward kernel kept. ``VARIANTS`` patch this
checkout's source; with ``--tree DIR`` the source of the checkout at DIR
(the parent's, unpacked with ``git archive``) is built as ``parent`` and
``PARENT_VARIANTS`` patch it (written against the design with one block
per 64 value rows in the carry pass). For each: the call's time (CUDA
events, L2 flushed before each call; min, median and max over the rounds'
calls, the variants in turns, in reverse order every other round), each
kernel's device time (torch.profiler), and each output's largest error
against ``mlstm_chunkwise_bwd_ref`` in f64 as a share of its largest value
(a variant that drops work is wrong by design: its time says what the rest
costs). With ``--holds``, ``chip_smoke.check_mlstm_bwd``'s holds run on
each variant named (the forwards stay this checkout's), and the holds it
fails are printed (a mutant's). With ``--dn0-bits``, every variant's dn0
on one input with a start state (B2 H2 S200 hd64 f32, q x 20) is compared
bit for bit with the first's.

This checkout's variants:

* ``kept``: the source as it is;
* ``three-mma``: every product as three TF32 products, also where an
  operand's low half is zero (bf16 q, k, v);
* ``one-mma``: a_hi b_hi alone (wrong: the mutant the dn0 hold is for);
* ``no-mma``: no tensor-core product, the operands still loaded and split
  (wrong);
* ``carry-chain-only``: the carry pass's dC tiles return at once (wrong:
  the chain blocks' time alone); ``carry-tiles-only``: the chain blocks
  return at once (wrong: the dC tiles' time alone);
* ``no-ring``: each wait on the rings waits for the next stage's copies
  too, so no copy overlaps the products.

The parent's variants:

* ``kept``; ``carry-tiles-only``: the n row's block returns at once
  (wrong: the dC tiles' time); ``carry-nrow-only``: the dC tiles return at
  once (wrong: the n row's block's time); ``no-chain``: the n row's block
  without the stabilizer chain's serial loop (wrong); ``no-mma`` (wrong);
  ``one-mma``: a_hi b_hi alone (wrong); ``no-load``: the synchronous tile
  loads dropped (wrong); ``p-none``: no P = q k^T in the parallel pass
  (wrong: the most sharing P could save).

Needs a CUDA device and nvcc, as the port's build does; prints one line
per variant, dtype and round, then the card's name and power limit.
"""
from __future__ import annotations

import argparse
import subprocess
import sys
from pathlib import Path

REPO = Path(__file__).resolve().parents[1]

MMA3 = "  mma(d, a.lo, bh[0], bh[1]);\n  mma(d, a.hi, bl[0], bl[1]);\n"
XOR_ALL = " ^ ".join([f"a.{h}[{i}]" for h in ("hi", "lo") for i in range(4)] +
                     ["bh[0]", "bh[1]", "bl[0]", "bl[1]"])
NO_MMA = [(MMA3 + "  mma(d, a.hi, bh[0], bh[1]);\n", f"  d[0] += __uint_as_float({XOR_ALL});\n")]

# ---- this checkout ----
CHAIN = "  // ---- the stabilizer chain (b), from the prep's e_t and won_t ----\n"
MMAS = ("  if constexpr (ALO) mma(d, a.lo, bh[0], bh[1]);\n"
        "  if constexpr (BLO) mma(d, a.hi, bl[0], bl[1]);\n")
VARIANTS = {
    "kept": [],
    "three-mma": [("constexpr bool kLoZero = sizeof(T) == 2;", "constexpr bool kLoZero = false;")],
    "one-mma": [(MMAS, "")],
    "no-mma": [(MMAS + "  mma(d, a.hi, bh[0], bh[1]);\n",
                "  d[0] += __uint_as_float(a.hi[0] ^ a.lo[0] ^ bh[0] ^ bh[1] ^ bl[0] ^ bl[1]);\n")],
    "carry-chain-only": [("  if (int(blockIdx.x) < ntiles) {\n",
                          "  if (int(blockIdx.x) < ntiles) {\n    return;\n")],
    "carry-tiles-only": [(CHAIN, "  return;\n")],
    "no-ring": [("repro::cp_async_wait<1>();", "repro::cp_async_wait<0>();")],
}

# ---- the parent: a carry block per 64 value rows, synchronous loads ----
PARENT_VARIANTS = {
    "kept": [],
    "carry-tiles-only": [("  // ---- the n row, dh . h, phi and the stabilizer chain ----\n",
                          "  return;\n")],
    "carry-nrow-only": [("    // ---- VT value rows of dC on the tensor cores ----\n",
                         "    return;\n")],
    "no-chain": [("    if (tid == 0) {\n      for (int t = Lc - 1; t >= 0; --t) {",
                  "    if (tid < 0) {\n      for (int t = Lc - 1; t >= 0; --t) {")],
    "no-mma": NO_MMA,
    "one-mma": [(MMA3, "")],
    "no-load": [("  for (int e = threadIdx.x; e < CH * W; e += NT) {",
                 "  for (int e = threadIdx.x; e < 0; e += NT) {")],
    "p-none": [("    if (p_live) {\n      float Pt[4][4];",
                "    if (false) {\n      float Pt[4][4];")],
}
SHAPE = dict(B=1, S=4096, H=4, hd=512)
NAMES = ("dq", "dk", "dv", "dgates")


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--tree", default="", help="another checkout, built as 'parent'")
    ap.add_argument("--rounds", type=int, default=2, help="rounds over the variants")
    ap.add_argument("--reps", type=int, default=10, help="timed calls a variant and dtype a round")
    ap.add_argument("--only", default="", help="comma-separated variants, parent's as "
                                               "parent:NAME (default: all)")
    ap.add_argument("--holds", default="", help="comma-separated built variants to run "
                                                "chip_smoke.check_mlstm_bwd's holds on")
    ap.add_argument("--dn0-bits", action="store_true",
                    help="compare every variant's dn0 bits on one input with a start state")
    args = ap.parse_args()
    sys.path[:0] = [str(REPO / "src"), str(REPO)]
    import torch

    import chip_smoke as cs
    from repro_torch.kernels import _build
    from repro_torch.kernels.mlstm import kernel
    from repro_torch.kernels.mlstm.ref import mlstm_chunkwise_bwd_ref
    from tools.flash_bwd_variants import build

    if not torch.cuda.is_available():
        print("mlstm_bwd_variants: no CUDA device", file=sys.stderr)
        return 2
    torch.backends.cuda.matmul.allow_tf32 = False
    entries = ("repro_mlstm_bwd",)
    only = set(args.only.split(",")) if args.only else None
    pick = lambda names, pre: [n for n in names if only is None or pre + n in only]
    this_lib = _build.load()             # the forward kernels that keep the states
    libs = {f"this:{n}": lib for n, lib in build(
        _build.BUILD_DIR / "mlstm_bwd_variants" / "this", pick(VARIANTS, "this:") or ["kept"],
        "mlstm_bwd.cu", VARIANTS, entries, "mlstm_bwd").items()}
    if args.tree:
        csrc = Path(args.tree).resolve() / "src/repro_torch/csrc"
        libs.update({f"parent:{n}": lib for n, lib in build(
            _build.BUILD_DIR / "mlstm_bwd_variants" / "parent", pick(PARENT_VARIANTS, "parent:"),
            "mlstm_bwd.cu", PARENT_VARIANTS, entries, "mlstm_bwd", csrc).items()})
    gen = torch.Generator(device="cuda").manual_seed(0)
    flush = torch.empty(256 * 2**20, dtype=torch.uint8, device="cuda")
    B, S, H, hd = SHAPE["B"], SHAPE["S"], SHAPE["H"], SHAPE["hd"]
    cases = []
    for dtype in (torch.bfloat16, torch.float32):
        q, k, v, g, _ = cs._mlstm_inputs(gen, B, S, H, hd, dtype)
        dh = torch.randn((B, S, H, hd), generator=gen, device="cuda").to(dtype)
        _build._lib = this_lib
        h, _, kept = kernel.mlstm_chunkwise(q, k, v, g, None, keep=True)
        wit = mlstm_chunkwise_bwd_ref(*(t.double() for t in (q, k, v, g)), None, h.double(),
                                      dh.double(), None, kernel.CHUNK)
        tops = [float(w.abs().max()) for w in wit[:4]]
        cases.append((str(dtype)[6:], (q, k, v, g, h, dh, kept), wit[:4], tops))
        del wit
    torch.cuda.empty_cache()
    times = {(name, tag): [] for name in libs for tag, *_ in cases}
    for rnd in range(args.rounds):
        for name, lib in list(libs.items())[::-1 if rnd % 2 else 1]:
            _build._lib = lib          # the port's wrapper launches this variant
            for tag, a, wit, tops in cases:
                got = kernel.mlstm_bwd(*a)
                torch.cuda.synchronize()
                errs = ", ".join(f"{n} {float((x.double() - w).abs().max()) / top:.3e}"
                                 for n, x, w, top in zip(NAMES, got[:4], wit, tops))
                del got
                tt = cs.time_each(lambda: kernel.mlstm_bwd(*a), flush, reps=args.reps)
                times[name, tag] += tt
                dev = cs._device_ms_per_launch(lambda: kernel.mlstm_bwd(*a), flush, "mlstm_bwd",
                                               reps=3)
                print(f"[mlstm_bwd_variants] {name} (round {rnd}) {tag}: {cs.fmt_spread(tt)}; "
                      "device ms " + ", ".join(f"{k} {v:.4f}" for k, v in sorted(dev.items())) +
                      f"; error off the f64 witness / its largest value: {errs}", flush=True)
    for (name, tag), t in times.items():
        if t:
            print(f"[mlstm_bwd_variants] {name} {tag}, all rounds: {cs.fmt_spread(t)}")
    del cases
    _build._lib = this_lib
    if args.dn0_bits:
        # dn0 (the n row stepped back on FMAs) of every variant on one input
        # with a start state, against the first variant's bits
        q, k, v, g, state = cs._mlstm_inputs(gen, 2, 200, 2, 64, torch.float32, True)
        q = q * 20.0
        dh = torch.randn(q.shape, generator=gen, device="cuda")
        h, fin, kept = kernel.mlstm_chunkwise(q, k, v, g, state, keep=True)
        first = None
        for name, lib in libs.items():
            _build._lib = lib
            dn0 = kernel.mlstm_bwd(q, k, v, g, h, dh, kept, fin[:2], None, want_dstate=True)[4][1]
            first = dn0 if first is None else first
            print(f"[mlstm_bwd_variants] dn0 of {name}: the same bits as "
                  f"{next(iter(libs))}'s: {torch.equal(dn0, first)}", flush=True)
        _build._lib = this_lib
    launch = kernel.mlstm_bwd
    for name in filter(None, args.holds.split(",")):
        def mlstm_bwd(*a, lib=libs[name], **kw):
            _build._lib = lib
            try:
                return launch(*a, **kw)
            finally:
                _build._lib = this_lib
        kernel.mlstm_bwd = mlstm_bwd     # the forwards stay this checkout's
        try:
            cs.check_mlstm_bwd(gen, flush)
            print(f"[mlstm_bwd_variants] holds of {name}: every hold passes", flush=True)
        except AssertionError as e:
            print(f"[mlstm_bwd_variants] holds of {name}: {e}", flush=True)
        finally:
            kernel.mlstm_bwd = launch
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True).stdout.strip())
    return 0


if __name__ == "__main__":
    sys.exit(main())
