#!/usr/bin/env python3
"""Time the port's sLSTM kernels, their parts and text-patched variants on one card.

    python3 tools/slstm_variants.py [--tree build/parent] [--rounds 2] [--only kept,no-wait]
                                    [--backward]

Each variant is ``csrc/slstm.cu`` with a few lines replaced, compiled on
its own (one nvcc each, in parallel, by ``tools/flash_bwd_variants.py``'s
``build``, which prints each build's ptxas registers and spill stores).
``VARIANTS`` (or with ``--backward`` ``BWD_VARIANTS``) patch this
checkout's source; with ``--tree DIR`` the source of the checkout at DIR
(the parent's, unpacked with ``git archive``) is built as ``parent`` and
patched by ``VARIANTS`` (the forward is the same design in both) or by
``PARENT_BWD_VARIANTS`` (the backward's design before the step-tagged
exchange). Times: CUDA events, the L2 flushed before each call; min,
median and max over the rounds' calls, the variants in turns, in reverse
order every other round. A variant that drops work is wrong by design:
its time says what the rest costs.

Without ``--backward``: ``kernel.slstm`` on f32 inputs at xlstm-350m's
shapes (d 1024): training's microbatch B1 S4096, the prefill B8 S4096 and
decode's step B8 S1 from a start state; the median per step and the
largest error of hs and the final state against ``slstm_ref``. The
forward's variants (the step-tagged exchange):

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

With ``--backward``: ``slstm_bwd`` at B1 S4096 d1024 (training's
microbatch, no start state), each build's kernel alone (launched as the
wrapper does, a zeroed exchange buffer allocated each call) and the
wrapper's call with its dr product; µs a step from the kernel's median,
and the largest error of dwx against ``slstm_bwd_ref``. A build whose
launch is refused is reported and dropped. This checkout's backward (each
block's share of dpre r^T for every unit exchanged as step-tagged words):

* ``kept``; ``no-wait``: the shares of step t + 1 read without waiting for
  their tag (wrong); ``no-product``: zero shares sent, no dpre r^T terms
  (wrong); ``no-cell``: the cell without its exponentials, tanh and
  division (wrong); ``exchange-only``: neither (wrong): the exchange, the
  warps' sums, the block's barrier and the warps' copies of the cells;
* ``one-chain``, ``four-chains``: a thread's share of a unit summed in one
  or four chains over the 32 columns, where the kept source takes two;
* ``backoff32``, ``backoff128``: a thread whose words are not all tagged
  sleeps that many ns before reloading them;
* ``cluster2``: the cooperative launch with a cluster dimension of 2 (the
  kernels do not use the cluster): whether the card takes one.

The parent's backward (one counter, ``grid_arrive`` / ``grid_wait``, dpre
staged in shared memory, two batch rows a pass over r's rows in shared
memory): ``kept``; ``no-wait``: no grid wait (wrong); ``no-stage``: dpre
not staged (wrong); ``no-product``; ``no-cell``; ``exchange-only``: the
barrier, the staging and the block's barriers alone; ``one-row``: one
batch row a pass, where the kept source computes a second, zero one at
B1.

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
    "no-wait": [(UNTAGGED, "            pending = 0;\n")],
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

# ---- the backward (--backward) ----
# the cell's arithmetic, the same text in both sources
B_CELL = ("        const float z = tanhf(x.pre[0]);\n        const float o = sigmoid(x.pre[3]);\n"
          "        const float fm = x.pre[2] + x.mp;\n"
          "        const float i_ = expf(x.pre[1] - x.m);\n"
          "        const float f_ = expf(fm - x.m);\n")
B_CHEAP_CELL = ("        const float z = x.pre[0];\n        const float o = x.pre[3];\n"
                "        const float fm = x.pre[2] + x.mp;\n"
                "        const float i_ = x.pre[1] - x.m;\n        const float f_ = fm - x.m;\n")
B_DIV = "        const float gq = dh / nc;\n"
B_NO_CELL = [(B_CELL, B_CHEAP_CELL), (B_DIV, B_DIV.replace("dh / nc", "dh * nc"))]
B_WAIT = "        pending = untagged(L, pending, want);\n"
B_PRODUCT = ("              p[k][m] = fmaf(dv.x, rr[m][e], p[k][m]);\n"
             "              p[k][m] = fmaf(dv.y, rr[m][e + 1], p[k][m]);\n"
             "              p[k][m] = fmaf(dv.z, rr[m][e + 2], p[k][m]);\n"
             "              p[k][m] = fmaf(dv.w, rr[m][e + 3], p[k][m]);\n")
B_NPB = "constexpr int NPB = 2;"
# the cooperative launch with a cluster dimension of 2 (both kernels; they
# do not use the cluster): does the card take it?
B_CLUSTER2 = [("    err = cudaLaunchCooperativeKernel(reinterpret_cast<const void*>(kernel), "
               "dim3(blocks),\n                                      dim3(NT), params, smem, "
               "stream);\n",
               "    (void)params;\n"
               "    cudaLaunchConfig_t cfg = {};\n"
               "    cfg.gridDim = dim3(blocks);\n    cfg.blockDim = dim3(NT);\n"
               "    cfg.dynamicSmemBytes = smem;\n    cfg.stream = stream;\n"
               "    cudaLaunchAttribute attr[2];\n"
               "    attr[0].id = cudaLaunchAttributeCooperative;\n"
               "    attr[0].val.cooperative = 1;\n"
               "    attr[1].id = cudaLaunchAttributeClusterDimension;\n"
               "    attr[1].val.clusterDim.x = 2;\n    attr[1].val.clusterDim.y = 1;\n"
               "    attr[1].val.clusterDim.z = 1;\n"
               "    cfg.attrs = attr;\n    cfg.numAttrs = 2;\n"
               "    err = cudaLaunchKernelEx(&cfg, kernel, copy);\n")]
BWD_VARIANTS = {
    "kept": [],
    "one-chain": [(B_NPB, "constexpr int NPB = 1;")],
    "four-chains": [(B_NPB, "constexpr int NPB = 4;")],
    **{f"backoff{ns}": [(B_WAIT, B_WAIT + f"        if (pending) __nanosleep({ns});\n")]
       for ns in (32, 128)},
    "no-wait": [(B_WAIT, "        pending = 0;\n")],
    "no-product": [(B_PRODUCT, "")],
    "no-cell": B_NO_CELL,
    "exchange-only": [(B_PRODUCT, ""), *B_NO_CELL],
    "cluster2": B_CLUSTER2,
}
# the parent's backward: one counter, grid_arrive / grid_wait, dpre staged in
# shared memory, 2 batch rows a pass over r's rows in shared memory
PB_WAIT = "    if (t < S - 1) grid_wait(a.counter, phase * gridDim.x);\n"
PB_STAGE = "  for (int i = threadIdx.x; i < nb * d; i += NT) {     // d float4s a row\n"
PB_PRODUCT = "  for (int q = tid; q < d; q += NT) {      // 4d columns = d float4s\n"
PARENT_BWD_VARIANTS = {
    "kept": [],
    "no-wait": [(PB_WAIT, "")],
    "no-stage": [(PB_STAGE, PB_STAGE.replace("i < nb * d", "i < 0"))],
    "no-product": [(PB_PRODUCT, PB_PRODUCT.replace("q < d", "q < 0"))],
    "no-cell": B_NO_CELL,
    "exchange-only": [(PB_PRODUCT, PB_PRODUCT.replace("q < d", "q < 0")), *B_NO_CELL],
    "one-row": [("constexpr int BTB = 2;", "constexpr int BTB = 1;")],
}
D = 1024
# (tag, B, S, with a start state): training's microbatch, the prefill, decode's step
SHAPES = [("B1 S4096", 1, 4096, False), ("B8 S4096", 8, 4096, False), ("B8 S1", 8, 1, True)]


def _bwd_call(lib, r, hs, kept, dhs):
    """One launch of a build's backward kernel on what this checkout's
    wrapper allocates (dpre, its zeroed exchange buffer, whose first word
    the parent's kernel takes as its counter), without the dr product."""
    import torch

    from repro_torch.kernels import _build
    from repro_torch.kernels.slstm import kernel

    B, S, d = hs.shape
    dpre = torch.empty((B, S, 4 * d), dtype=torch.float32, device="cuda")
    x = kernel._bwd_exchange(B, S, d, False, torch.device("cuda"))
    err = lib.repro_slstm_bwd(r.data_ptr(), hs.data_ptr(), *(t.data_ptr() for t in kept),
                              None, None, None, dhs.data_ptr(), None, None, None, None,
                              dpre.data_ptr(), None, None, None, None, x.data_ptr(), B, S, d,
                              torch.cuda.current_stream().cuda_stream, None)
    _build.check(err, "slstm_bwd variant")
    return dpre


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--tree", default="", help="another checkout, built as 'parent'")
    ap.add_argument("--rounds", type=int, default=2, help="rounds over the variants")
    ap.add_argument("--reps", type=int, default=10, help="timed calls a variant and shape a round")
    ap.add_argument("--only", default="", help="comma-separated variants, parent's as "
                                               "parent:NAME (default: all)")
    ap.add_argument("--backward", action="store_true",
                    help="the backward's variants at B1 S4096, not the forward's")
    args = ap.parse_args()
    sys.path[:0] = [str(REPO / "src"), str(REPO)]
    import torch

    import chip_smoke as cs
    from repro_torch.kernels import _build
    from repro_torch.kernels.slstm import kernel
    from repro_torch.kernels.slstm.ref import slstm_bwd_ref, slstm_ref
    from tools.flash_bwd_variants import build

    if not torch.cuda.is_available():
        print("slstm_variants: no CUDA device", file=sys.stderr)
        return 2
    torch.backends.cuda.matmul.allow_tf32 = False
    entries = ("repro_slstm_fwd", "repro_slstm_bwd")
    mine, theirs = (BWD_VARIANTS, PARENT_BWD_VARIANTS) if args.backward else (VARIANTS, VARIANTS)
    only = set(args.only.split(",")) if args.only else None
    pick = lambda names, pre: [n for n in names if only is None or pre + n in only]
    libs = {f"this:{n}": lib for n, lib in build(
        _build.BUILD_DIR / "slstm_variants" / "this", pick(mine, "this:") or ["kept"],
        "slstm.cu", mine, entries, "slstm_").items()}
    if args.tree:
        csrc = Path(args.tree).resolve() / "src/repro_torch/csrc"
        libs.update({f"parent:{n}": lib for n, lib in build(
            _build.BUILD_DIR / "slstm_variants" / "parent", pick(theirs, "parent:"),
            "slstm.cu", theirs, entries, "slstm_", csrc).items()})
    for lib in libs.values():
        try:
            lib.repro_slstm_units
        except AttributeError:   # a library built before the wide grids: 8 units a block
            lib.repro_slstm_units = lambda B, d, backward: 8
    gen = torch.Generator(device="cuda").manual_seed(0)
    flush = torch.empty(256 * 2**20, dtype=torch.uint8, device="cuda")
    if args.backward:
        # training's microbatch; every build's forward is the same source
        S = 4096
        _build._lib = next(iter(libs.values()))
        wx, r, _ = cs._slstm_inputs(gen, 1, S, D, False)
        hs, _, kept = kernel.slstm(wx, r, None, keep=True)
        dhs = torch.randn((1, S, D), generator=gen, device="cuda")
        want = slstm_bwd_ref(r, None, hs, kept, dhs, None)[0]
        times = {n: ([], []) for n in libs}
        for rnd in range(args.rounds):
            for name, lib in list(libs.items())[::-1 if rnd % 2 else 1]:
                if name not in times:
                    continue
                _build._lib = lib      # the port's wrapper launches this build
                bare = lambda: _bwd_call(lib, r, hs, kept, dhs)
                try:
                    err = float((bare() - want).abs().max())
                except RuntimeError as e:
                    print(f"[slstm_variants] slstm_bwd {name}: refused at launch: {e}", flush=True)
                    del times[name]
                    continue
                tk = cs.time_each(bare, flush, reps=args.reps)
                tc = cs.time_each(lambda: kernel.slstm_bwd(r, None, hs, kept, dhs), flush,
                                  reps=args.reps)
                times[name][0].extend(tk)
                times[name][1].extend(tc)
                print(f"[slstm_variants] slstm_bwd {name} (round {rnd}) B1 S{S}: kernel "
                      f"{cs.fmt_spread(tk)}, {1e3 * cs.spread(tk)[1] / S:.3f} us a step; with "
                      f"the wrapper's dr {cs.fmt_spread(tc)}; largest error of dwx off "
                      f"slstm_bwd_ref {err:.3e}", flush=True)
        for name, (tk, tc) in times.items():
            print(f"[slstm_variants] slstm_bwd {name} B1 S{S}, all rounds: kernel "
                  f"{cs.fmt_spread(tk)}, {1e3 * cs.spread(tk)[1] / S:.3f} us a step; with the "
                  f"wrapper's dr {cs.fmt_spread(tc)}")
    else:
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
                          f"{1e3 * cs.spread(tt)[1] / S:.3f} us a step; largest error of hs and "
                          f"the final state off slstm_ref {err:.3e}", flush=True)
        for (name, tag), t in times.items():
            S = next(c[1] for c in cases if c[0] == tag)
            print(f"[slstm_variants] {name} {tag}, all rounds: {cs.fmt_spread(t)}, "
                  f"{1e3 * cs.spread(t)[1] / S:.3f} us a step")
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True).stdout.strip())
    return 0


if __name__ == "__main__":
    sys.exit(main())
