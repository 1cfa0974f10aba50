#!/usr/bin/env python3
"""Time the port's sLSTM forward kernel, its parts and text-patched variants on one card.

    python3 tools/slstm_variants.py [--tree build/parent] [--rounds 2] [--only kept,no-wait]
                                    [--backward]

Each variant is ``csrc/slstm.cu`` with a few lines replaced, compiled on
its own (one nvcc each, in parallel, by ``tools/flash_bwd_variants.py``'s
``build``, which prints each build's ptxas registers and spill stores) and
called through the port's wrapper ``kernel.slstm`` on f32 inputs at
xlstm-350m's shapes (d 1024): training's microbatch B1 S4096, the prefill
B8 S4096 and decode's step B8 S1 from a start state. ``VARIANTS`` patch
this checkout's source; with ``--tree DIR`` the source of the checkout at
DIR (the parent's, unpacked with ``git archive``) is built as ``parent``,
and ``PARENT_VARIANTS`` patch it (they are written against the design
before the step-tagged exchange). For each: the kernel's time (CUDA events,
L2 flushed before each call; min, median and max over the rounds' calls,
the variants in turns, in reverse order every other round), the median per
step, and the largest error of hs and the final state against
``slstm_ref`` (a variant that drops work is wrong by design: its time says
what the rest costs). With ``--backward``, ``kernel.slstm_bwd`` at B1
S4096 too, for each checkout's unpatched source.

This checkout's variants (the step-tagged exchange):

* ``kept``: the source as it is;
* ``no-wait``: a step's h is read without waiting for its tag (wrong: the
  exchange's wait);
* ``poll-all``: a waiting lane reloads every line of its round, not only
  those not tagged yet;
* ``no-product``: no h r product (wrong: what the product costs);
* ``no-cell``: the cell without its exponentials, tanh and division;
* ``exchange-only``: neither product nor cell math: what the exchange, the
  staging and the block's one barrier a step cost;
* ``no-split``: one accumulator a batch row, not four (the product's
  dependent chain at B1);
* ``r-smem``: 4 rows of r a lane in registers, the rest read from shared
  memory every step;
* ``lb8``, ``lb16``: 8 or 16 exchange loads a lane in flight at every
  shape, where the kept source takes as many as a tile needs (2 at B1, 16
  at B8, d 1024);
* ``cg-loads``, ``volatile-loads``: the exchange read by weak L2 loads
  (``ld.global.cg``) or by volatile ones in place of relaxed ones (the
  first is outside the memory model's guarantees: timing only);
* ``no-clobber``: the exchange loads without a memory clobber;
* ``backoff64``, ``backoff256``, ``backoff1k``: a lane whose lines are not
  all tagged sleeps that many ns before reloading them (fewer polls in
  L2's way).

The parent's variants (one counter, ``grid_arrive`` / ``grid_wait``):

* ``kept``; ``no-wait``: no grid wait (wrong); ``no-exchange``: neither the
  arrival nor the wait (wrong); ``no-stage``: h not staged from L2 (wrong);
  ``no-product``; ``no-cell``; ``exchange-only``: the barrier, the staging
  loop's bookkeeping and the block's barriers alone.

Needs a CUDA device and nvcc, as the port's build does; prints one line
per variant, shape and round, then the card's name and power limit.
"""
from __future__ import annotations

import argparse
import subprocess
import sys
from pathlib import Path

REPO = Path(__file__).resolve().parents[1]

# ---- this checkout: the step-tagged exchange ----
TAGGED = "  return (v.x >> 32) == want && (v.y >> 32) == want;"
PRODUCT = "#pragma unroll\n        for (int i = 0; i < KR; i += 4) {"
OVERFLOW = "        for (int k = KR; k < ks; k += 4) {"
CELL = ("        const float z = tanhf(pre[0]);\n        const float o = sigmoid(pre[3]);\n"
        "        const float fm = pre[2] + m;\n        const float mn = fmaxf(fm, pre[1]);\n"
        "        const float i_ = expf(pre[1] - mn);\n        const float f_ = expf(fm - mn);\n"
        "        c = f_ * c + i_ * z;\n        n = f_ * n + i_;\n"
        "        const float h = o * c / fmaxf(n, 1.f);\n")
UNTAGGED = "            pending = untagged(lines, pending, want);\n"
CHEAP_CELL = ("        const float z = pre[0];\n        const float o = pre[3];\n"
              "        const float fm = pre[2] + m;\n        const float mn = fmaxf(fm, pre[1]);\n"
              "        const float i_ = pre[1] - mn;\n        const float f_ = fm - mn;\n"
              "        c = f_ * c + i_ * z;\n        n = f_ * n + i_;\n"
              "        const float h = o * c;\n")
VARIANTS = {
    "kept": [],
    "no-wait": [(TAGGED, "  return true;")],
    "poll-all": [("            load_lines(lines, src, d, r0, c0, per_row, pending);",
                  "            load_lines(lines, src, d, r0, c0, per_row, mine);")],
    "no-product": [(PRODUCT, PRODUCT.replace("i < KR", "i < 0")),
                   (OVERFLOW, OVERFLOW.replace("k = KR", "k = ks"))],
    "no-cell": [(CELL, CHEAP_CELL)],
    "exchange-only": [(PRODUCT, PRODUCT.replace("i < KR", "i < 0")),
                      (OVERFLOW, OVERFLOW.replace("k = KR", "k = ks")),
                      (CELL, CHEAP_CELL)],
    "no-split": [("constexpr int NP = 4;", "constexpr int NP = 1;")],
    "r-smem": [("  while (kr < 128 && 2 * kr <= ks) kr *= 2;\n", "")],
    "lb8": [("  return lines <= 2 ? 2 : lines <= 4 ? 4 : lines <= 8 ? 8 : 16;", "  return 8;")],
    "lb16": [("  return lines <= 2 ? 2 : lines <= 4 ? 4 : lines <= 8 ? 8 : 16;", "  return 16;")],
    "cg-loads": [("ld.relaxed.gpu.global.v2.b64", "ld.global.cg.v2.u64")],
    "volatile-loads": [("ld.relaxed.gpu.global.v2.b64", "ld.volatile.global.v2.u64")],
    "no-clobber": [(': "=l"(v.x), "=l"(v.y) : "l"(p) : "memory");',
                    ': "=l"(v.x), "=l"(v.y) : "l"(p));')],
    **{f"backoff{name}": [(UNTAGGED, UNTAGGED + f"            if (pending) __nanosleep({ns});\n")]
       for name, ns in (("64", 64), ("256", 256), ("1k", 1024))},
}

# ---- the parent: one counter, grid_arrive / grid_wait ----
P_WAIT = "    if (t > 0) grid_wait(a.counter, phase * gridDim.x);\n"
P_ARRIVE = "    if (t + 1 < S) {\n      grid_arrive(a.counter);\n      ++phase;\n    }\n"
P_STAGE = "        for (int i = tid; i < nb * dq; i += NT) {"
P_PRODUCT = "      for (int k = kb; k < kb + ks; k += 4) {"
P_CELL = ("        const float z = tanhf(pre[0]);\n        const float o = sigmoid(pre[3]);\n"
          "        const float fm = pre[2] + m;\n        const float mn = fmaxf(fm, pre[1]);\n"
          "        const float i_ = expf(pre[1] - mn);\n        const float f_ = expf(fm - mn);\n"
          "        c = f_ * c + i_ * z;\n        n = f_ * n + i_;\n"
          "        const float h = o * c / fmaxf(n, 1.f);\n")
PARENT_VARIANTS = {
    "kept": [],
    "no-wait": [(P_WAIT, "")],
    "no-exchange": [(P_WAIT, ""), (P_ARRIVE, "")],
    "no-stage": [(P_STAGE, P_STAGE.replace("i < nb * dq", "i < 0"))],
    "no-product": [(P_PRODUCT, P_PRODUCT.replace("k < kb + ks", "k < kb"))],
    "no-cell": [(P_CELL, CHEAP_CELL)],
    "exchange-only": [(P_STAGE, P_STAGE.replace("i < nb * dq", "i < 0")),
                      (P_PRODUCT, P_PRODUCT.replace("k < kb + ks", "k < kb")),
                      (P_CELL, CHEAP_CELL)],
}
D = 1024
# (tag, B, S, with a start state): training's microbatch, the prefill, decode's step
SHAPES = [("B1 S4096", 1, 4096, False), ("B8 S4096", 8, 4096, False), ("B8 S1", 8, 1, True)]


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--tree", default="", help="another checkout, built as 'parent'")
    ap.add_argument("--rounds", type=int, default=2, help="rounds over the variants")
    ap.add_argument("--reps", type=int, default=10, help="timed calls a variant and shape a round")
    ap.add_argument("--only", default="", help="comma-separated variants, parent's as "
                                               "parent:NAME (default: all)")
    ap.add_argument("--backward", action="store_true", help="also time slstm_bwd at B1 S4096")
    args = ap.parse_args()
    sys.path[:0] = [str(REPO / "src"), str(REPO)]
    import torch

    import chip_smoke as cs
    from repro_torch.kernels import _build
    from repro_torch.kernels.slstm import kernel
    from repro_torch.kernels.slstm.ref import slstm_ref
    from tools.flash_bwd_variants import build

    if not torch.cuda.is_available():
        print("slstm_variants: no CUDA device", file=sys.stderr)
        return 2
    entries = ("repro_slstm_fwd", "repro_slstm_bwd")
    only = set(args.only.split(",")) if args.only else None
    pick = lambda names, pre: [n for n in names if only is None or pre + n in only]
    libs = {f"this:{n}": lib for n, lib in build(
        _build.BUILD_DIR / "slstm_variants" / "this", pick(VARIANTS, "this:") or ["kept"],
        "slstm.cu", VARIANTS, entries, "slstm_").items()}
    if args.tree:
        csrc = Path(args.tree).resolve() / "src/repro_torch/csrc"
        libs.update({f"parent:{n}": lib for n, lib in build(
            _build.BUILD_DIR / "slstm_variants" / "parent", pick(PARENT_VARIANTS, "parent:"),
            "slstm.cu", PARENT_VARIANTS, entries, "slstm_", csrc).items()})
    gen = torch.Generator(device="cuda").manual_seed(0)
    flush = torch.empty(256 * 2**20, dtype=torch.uint8, device="cuda")
    cases = []
    for tag, B, S, with_state in SHAPES:
        wx, r, state = cs._slstm_inputs(gen, B, S, D, with_state)
        hs, fin = slstm_ref(wx, r, state)
        cases.append((tag, S, (wx, r, state), (hs, *fin)))
    times = {(name, tag): [] for name in libs for tag, *_ in cases}
    for rnd in range(args.rounds):
        for name, lib in list(libs.items())[::-1 if rnd % 2 else 1]:
            _build._lib = lib          # the port's wrapper launches this variant
            for tag, S, a, ref in cases:
                hs, fin = kernel.slstm(*a)
                torch.cuda.synchronize()
                err = max(float((x - y).abs().max()) for x, y in zip((hs, *fin), ref))
                del hs, fin
                tt = cs.time_each(lambda: kernel.slstm(*a), flush, reps=args.reps)
                times[name, tag] += tt
                print(f"[slstm_variants] {name} (round {rnd}) {tag}: {cs.fmt_spread(tt)}, "
                      f"{1e3 * cs.spread(tt)[1] / S:.3f} us a step; largest error of hs and the "
                      f"final state off slstm_ref {err:.3e}", flush=True)
    for (name, tag), t in times.items():
        S = next(c[1] for c in cases if c[0] == tag)
        print(f"[slstm_variants] {name} {tag}, all rounds: {cs.fmt_spread(t)}, "
              f"{1e3 * cs.spread(t)[1] / S:.3f} us a step")
    if args.backward:
        wx, r, _ = cs._slstm_inputs(gen, 1, 4096, D, False)
        _build._lib = libs["this:kept"]
        hs, _, kept = kernel.slstm(wx, r, None, keep=True)
        dhs = torch.randn((1, 4096, D), generator=gen, device="cuda")
        bwd = {n: lib for n, lib in libs.items() if n.endswith(":kept")}
        bt = {n: [] for n in bwd}
        for rnd in range(args.rounds):
            for name, lib in list(bwd.items())[::-1 if rnd % 2 else 1]:
                _build._lib = lib
                bt[name] += cs.time_each(lambda: kernel.slstm_bwd(r, None, hs, kept, dhs), flush,
                                         reps=args.reps)
        for name, t in bt.items():
            print(f"[slstm_variants] slstm_bwd {name} B1 S4096 (with the wrapper's dr product), "
                  f"all rounds: {cs.fmt_spread(t)}, {1e3 * cs.spread(t)[1] / 4096:.3f} us a step")
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True).stdout.strip())
    return 0


if __name__ == "__main__":
    sys.exit(main())
