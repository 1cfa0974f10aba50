#!/usr/bin/env python3
"""Time text-patched variants of the port's f32 flash forward on one card.

    python3 tools/flash_fwd_variants.py [--rounds 2] [--only kept,w4]

Each variant is ``src/repro_torch/csrc/flash_attention.cu`` (and the
split-TF32 helpers it includes, ``csrc/tf32.cuh``) with a few lines
replaced, compiled on its own (one nvcc each, in parallel, by
``tools/flash_bwd_variants.py``'s ``build``) and called through the port's
wrapper on f32 inputs at the f32 forward's timed shapes
(``chip_smoke.py``'s ``F32_FWD_SHAPES``). For each: the kernel's time
(CUDA events, L2 flushed before each call; min, median and max over the
rounds' calls, the variants in turns) and its largest errors of o and lse
against ``attention_fwd_ref`` (a variant that drops arithmetic is wrong by
design; its time says what the rest costs). The variants:

* ``kept``: the source as it is (``Layout``: 8 warps over 128 q rows from
  hd 128 up, 16-row kv tiles at hd 256; 4 warps over 64 q rows below);
* ``w4``: 4 warps over 64 q rows at every head dim, with 32-row kv tiles
  and a tile's share of o over 4 column blocks at hd 256 (the first
  layout);
* ``w8-hd64``: 8 warps over 128 q rows below hd 128 too;
* ``ng4``: a tile's share of o over 4 column blocks at a time at hd 256,
  not 2 (more products in flight, more registers);
* ``kc1``: s = Q K^T's loop over the head dim not unrolled (fewer
  fragments in flight);
* ``div``: o divided by l in the epilogue (an IEEE division) in place of
  a multiply by its approximate reciprocal;
* ``no-split``: x handed over as hi and as lo, with no arithmetic: the
  split's cost (wrong by design);
* ``one-mma``: only a_hi b_hi of the three products (wrong by design).

Needs a CUDA device and nvcc, as the port's build does; prints one line
per variant, shape and round, then the card's name and power limit.
"""
from __future__ import annotations

import argparse
import subprocess
import sys
from pathlib import Path

REPO = Path(__file__).resolve().parents[1]

WARPS = "  static constexpr int WARPS = HD >= 128 ? 8 : 4;"
BK = "  static constexpr int BK = HD > 128 ? 16 : 64;      // kv rows a streamed tile"
NG = "  static constexpr int NG = HD > 128 ? 2 : HD / 8;"
KC = "#pragma unroll 2\n      for (int kc = 0; kc < HD; kc += 8) {       // s = Q K^T"
VARIANTS = {
    "kept": [],
    "w4": [(WARPS, "  static constexpr int WARPS = 4;"),
           (BK, BK.replace("HD > 128 ? 16 : 64", "HD > 128 ? 32 : 64")),
           (NG, NG.replace("HD > 128 ? 2", "HD > 128 ? 4"))],
    "w8-hd64": [(WARPS, "  static constexpr int WARPS = 8;")],
    "ng4": [(NG, NG.replace("HD > 128 ? 2", "HD > 128 ? 4"))],
    "kc1": [(KC, KC.replace("unroll 2", "unroll 1"))],
    "div": [("make_float2(o[n][2 * r] * inv, o[n][2 * r + 1] * inv)",
             "make_float2(o[n][2 * r] / li, o[n][2 * r + 1] / li)")],
    "no-split": [("  hi = rna(x);\n  lo = rna(x - __uint_as_float(hi));",
                  "  hi = lo = __float_as_uint(x);")],
    "one-mma": [("  mma(d, a.lo, bh[0], bh[1]);\n  mma(d, a.hi, bl[0], bl[1]);\n", "")],
}


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--rounds", type=int, default=2, help="rounds over the variants")
    ap.add_argument("--reps", type=int, default=10, help="timed calls a variant and shape a round")
    ap.add_argument("--only", default="", help="comma-separated variants (default: all)")
    args = ap.parse_args()
    sys.path[:0] = [str(REPO / "src"), str(REPO)]
    import torch

    import chip_smoke as cs
    from repro_torch.kernels import _build
    from repro_torch.kernels.flash_attention import kernel
    from repro_torch.kernels.flash_attention.ref import attention_fwd_ref
    from tools.flash_bwd_variants import build

    if not torch.cuda.is_available():
        print("flash_fwd_variants: no CUDA device", file=sys.stderr)
        return 2
    names = args.only.split(",") if args.only else list(VARIANTS)
    libs = build(_build.BUILD_DIR / "flash_fwd_variants", names, "flash_attention.cu", VARIANTS,
                 ("repro_flash_attention_fwd",), "tf32_kernel")
    gen = torch.Generator(device="cuda").manual_seed(0)
    flush = torch.empty(256 * 2**20, dtype=torch.uint8, device="cuda")
    cases = []
    for tag, B, S, H, KVH, hd, window in cs.F32_FWD_SHAPES:
        mk = lambda heads: torch.randn((B, S, heads, hd), generator=gen, device="cuda")
        q, k, v = mk(H), mk(KVH), mk(KVH)
        kw = dict(causal=True, window=window, q_offset=0)
        cases.append((tag, (q, k, v), kw, attention_fwd_ref(q, k, v, **kw)))
    times = {(name, tag): [] for name in libs for tag, *_ in cases}
    for rnd in range(args.rounds):
        for name, lib in libs.items():
            _build._lib = lib          # the port's wrapper launches this variant
            for tag, a, kw, (ro, rlse) in cases:
                o, lse = kernel.flash_attention_fwd(*a, **kw)
                torch.cuda.synchronize()
                err = {n: cs.within(x, r, cs.F32_TOL) for n, x, r in (("o", o, ro),
                                                                      ("lse", lse, rlse))}
                t = cs.time_each(lambda: kernel.flash_attention_fwd(*a, **kw), flush,
                                 reps=args.reps)
                times[name, tag] += t
                print(f"[flash_fwd_variants] {name} (round {rnd}) {tag}: {cs.fmt_spread(t)}; "
                      "max err (within F32_TOL) " +
                      ", ".join(f"{n} {e:.3e} ({ok})" for n, (e, ok) in err.items()), flush=True)
    for (name, tag), t in times.items():
        print(f"[flash_fwd_variants] {name} {tag}, all rounds: {cs.fmt_spread(t)}")
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True).stdout.strip())
    return 0


if __name__ == "__main__":
    sys.exit(main())
