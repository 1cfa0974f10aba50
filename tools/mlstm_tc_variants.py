#!/usr/bin/env python3
"""Time the tensor-core mLSTM's split design and text-patched variants of it on one card.

    python3 tools/mlstm_tc_variants.py [--rounds 2] [--reps 10] [--only kept,carry-no-store]

Each variant is ``csrc/mlstm_tc.cu`` with a few lines replaced, compiled on
its own (one nvcc each, in parallel, by ``tools/flash_bwd_variants.py``'s
``build``, which prints each build's ptxas registers and spill stores) and
called through ``kernel.tc_call("split", ...)`` at xlstm-350m's training
microbatch keeping its chunk states (B1 S4096 H4 hd512) and at its serving
prefill without keeping (B8), bf16; the single pass of the unpatched
source is timed beside them. For each: the call's time (CUDA events, L2
flushed before each call; min, median and max over the rounds' calls, the
variants in turns, in reverse order every other round), each kernel's
device time (torch.profiler), and h's largest difference from the
unpatched source's (a variant that drops work is wrong by design: its time
says what the rest costs).

* ``kept``: the source as it is;
* ``carry-no-store``: the carry writes no C_in (wrong: the chunk walk
  without its stores);
* ``carry-stages-2``: a ring of 2 chunks in the carry;
* ``carry-lb4``: the carry's registers capped for 4 blocks an SM;
* ``out-no-cin``: the output pass loads no C_in (wrong: its reads' cost);
* ``out-stages-2``: a ring of 2 slices in the output pass, registers
  capped for 3 blocks an SM;
* ``carry-no-mma``, ``carry-no-v``, ``carry-no-scalars``: the carry
  without its products, without reading V (V w taken as w), without
  working out the next chunk's scalars (all wrong: what the rest costs);
* ``out-no-mma``, ``out-no-epilogue``: the output pass without its
  products in the walk over the slices, or returning after it (wrong).

Needs a CUDA device and nvcc, as the port's build does; prints one line
per variant, shape and round, then the card's name and power limit.
"""
from __future__ import annotations

import argparse
import subprocess
import sys
from pathlib import Path

REPO = Path(__file__).resolve().parents[1]

CARRY_STORE = ("    float* kc = a.kC + ((bhc + ci) * hd + v0) * hd + c0;   // C_in\n"
               "#pragma unroll\n    for (int idx = 0; idx < 32; idx += 2) {")
CIN_LOADS = ("    hw::tma_load_3d(st + 2 * BOX, &mc, bar, j * TILE, v0, int(bhc));\n"
             "    hw::tma_load_3d(st + 3 * BOX, &mc, bar, j * TILE + TILE / 2, v0, int(bhc));\n")
CARRY_MMA = ("      hw::wgmma_rs_tb(C, vw_hi[ks], dk, 1);\n"
             "      hw::wgmma_rs_tb(C, vw_lo[ks], dk, 1);\n")
V_LOAD = ("x[idx] = __bfloat162float(*reinterpret_cast<const bf16*>(Vt + hw::swz128(s, r)))"
          " * w[s];")
OUT_P = ("      hw::wgmma_ss(P, hw::make_desc<128>(qs + kk * 32, 0, 1024),\n"
         "                   hw::make_desc<128>(ks + kk * 32, 0, 1024), 1);")
OUT_I = "      hw::wgmma_rs(I, c_hi[kk], dq, 1);\n      hw::wgmma_rs(I, c_lo[kk], dq, 1);"
VARIANTS = {
    "kept": [],
    "carry-no-store": [(CARRY_STORE, CARRY_STORE.replace("idx < 32", "idx < 0"))],
    "carry-stages-2": [("constexpr int CSTAGES = 4;", "constexpr int CSTAGES = 2;")],
    "carry-lb4": [("__launch_bounds__(128, 3)\nmlstm_tc_carry_kernel",
                   "__launch_bounds__(128, 4)\nmlstm_tc_carry_kernel")],
    "out-no-cin": [(CIN_LOADS, ""), ("hw::mbar_arrive_expect_tx(bar, 4 * BOX);",
                                     "hw::mbar_arrive_expect_tx(bar, 2 * BOX);")],
    "out-stages-2": [("constexpr int OSTAGES = 3;", "constexpr int OSTAGES = 2;"),
                     ("__launch_bounds__(128, 2)\nmlstm_tc_out_kernel",
                      "__launch_bounds__(128, 3)\nmlstm_tc_out_kernel")],
    "carry-no-mma": [(CARRY_MMA, "      C[ks] += __uint_as_float(vw_hi[ks][0] ^ vw_lo[ks][1]);\n")],
    "carry-no-v": [(V_LOAD, "x[idx] = w[s];")],
    "carry-no-scalars": [("if (warp == 0 && ci + 1 < n_chunks) {",
                          "if (warp == 0 && ci + 1 < 0) {")],
    "out-no-mma": [(OUT_P, "      P[kk] += 1.f;"),
                   (OUT_I, "      I[kk] += __uint_as_float(c_hi[kk][0] ^ c_lo[kk][1]);")],
    "out-no-epilogue": [("  if (half == 0) nqs[tq] = nq;\n",
                         "  if (half == 0) nqs[tq] = nq;\n  if (nq != 12345.f) return;\n")],
}
SHAPES = (("training B1 keeping", 1, True), ("prefill B8", 8, False))


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
    from repro_torch.kernels.mlstm import kernel
    from tools.flash_bwd_variants import build

    if not torch.cuda.is_available():
        print("mlstm_tc_variants: no CUDA device", file=sys.stderr)
        return 2
    names = [n for n in VARIANTS if not args.only or n in args.only.split(",")]
    this_lib = _build.load()
    libs = build(_build.BUILD_DIR / "mlstm_tc_variants", names, "mlstm_tc.cu", VARIANTS,
                 ("repro_mlstm_tc", "repro_mlstm_tc_split"), "mlstm_tc_")
    gen = torch.Generator(device="cuda").manual_seed(0)
    flush = torch.empty(256 * 2**20, dtype=torch.uint8, device="cuda")
    cases = []
    for tag, B, keep in SHAPES:
        q, k, v, g, _ = cs._mlstm_inputs(gen, B, 4096, 4, 512, torch.bfloat16)
        h_ref = kernel.tc_call("split", q, k, v, g)[0]
        cases.append((tag, (q, k, v, g), keep, h_ref))
    runs = {("single (unpatched)", tag): [] for tag, *_ in cases}
    runs.update({(name, tag): [] for name in libs for tag, *_ in cases})
    for rnd in range(args.rounds):
        order = [("single (unpatched)", this_lib)] + list(libs.items())
        for name, lib in order[::-1 if rnd % 2 else 1]:
            _build._lib = lib            # the port's wrapper launches this variant
            design = "single" if name.startswith("single") else "split"
            for tag, a, keep, h_ref in cases:
                fn = lambda: kernel.tc_call(design, *a, keep=keep)
                h = fn()[0]
                torch.cuda.synchronize()
                diff = float((h.float() - h_ref.float()).abs().max())
                del h
                tt = cs.time_each(fn, flush, reps=args.reps)
                runs[name, tag] += tt
                dev = cs._device_ms_per_launch(fn, flush, "mlstm_tc", reps=3)
                print(f"[mlstm_tc_variants] {name} (round {rnd}) {tag}: {cs.fmt_spread(tt)}; "
                      "device ms " + ", ".join(f"{k} {v:.4f}" for k, v in sorted(dev.items()))
                      + f"; h off the unpatched split's by at most {diff:.3e}", flush=True)
    _build._lib = this_lib
    for (name, tag), t in runs.items():
        print(f"[mlstm_tc_variants] {name} {tag}, all rounds: {cs.fmt_spread(t)}")
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True).stdout.strip())
    return 0


if __name__ == "__main__":
    sys.exit(main())
