#!/usr/bin/env python3
"""Time text-patched variants of the port's split-TF32 chunkwise mLSTM on one card.

    python3 tools/mlstm_variants.py [--rounds 2] [--only kept,vt32]

Each variant is ``src/repro_torch/csrc/mlstm.cu`` (and the split-TF32
helpers it includes, ``csrc/tf32.cuh``) with a few lines replaced, compiled
on its own (one nvcc each, in parallel, by ``tools/flash_bwd_variants.py``'s
``build``, which prints each build's ptxas registers and spill stores) and
called through the port's wrapper ``kernel.mlstm_tf32`` on f32 inputs at
xlstm-350m's prefill shape (B8 S4096 H4 hd512) and at head dim 64 with the
same inner width (B8 S4096 H32 hd64). For each: the kernel's time (CUDA
events, L2 flushed before each call; min, median and max over the rounds'
calls, the variants in turns, in reverse order every other round) and its
largest errors of h, C, n and m against ``mlstm_chunkwise_ref`` at chunk
256, and of h against the f64 recurrence (``chip_smoke._mlstm_f64``, with
the plain form's own beside it), as fractions of the limits
``chip_smoke.py`` holds the main shape to (a variant that drops arithmetic
is wrong by design; its time says what the rest costs). The variants:

* ``kept``: the source as it is (VT 64 value rows of C a block where hd %
  64 == 0, a 3-stage ring, each slice's update of C after a barrier behind
  its products, every operand split where a fragment reads it, (V w)^T's A
  fragments read from the V tile and w every slice, a share of P and inter
  per 32-column slice, every block computing all of q K^T);
* ``vw-regs``: (V w)^T's A fragments kept in registers for the chunk;
* ``vt32``: 32 value rows of C a block at every head dim (twice the blocks);
* ``cluster``: a head's blocks form one thread-block cluster; each computes
  q K^T over its own VT key columns and the shares are summed through
  distributed shared memory at each chunk's end;
* ``deferred``: each slice's update of C during the next slice's products
  (after the next slice's first barrier), one barrier a slice fewer;
* ``join-8``, ``join-128``, ``join-chunk``: a share of P and inter per 8
  key columns (every k step), per 128, or one share for the chunk's 512;
* ``kc-unroll1``: the products' loop over a slice's k steps not unrolled;
* ``no-split``: x handed over as hi and as lo, with no arithmetic (wrong by
  design: the split's cost);
* ``one-mma``: only a_hi b_hi of the three products (wrong by design);
* ``p-none``: no q K^T at all (wrong by design: what computing it in every
  block costs, the most a shared q K^T could save);
* ``no-mma``: no tensor-core product, the operands still loaded and split
  (wrong by design: what everything else costs).

Needs a CUDA device and nvcc, as the port's build does; prints one line
per variant, shape and round, then the card's name and power limit.
"""
from __future__ import annotations

import argparse
import subprocess
import sys
from pathlib import Path

REPO = Path(__file__).resolve().parents[1]

KC = ("#pragma unroll\n      for (int kc = 0; kc < KS; kc += 8) {        // P += q K^T, inter += "
      "q C_in^T")
VW = "const Frag fa = frag_trows<VT>(Vs, w_s, ks * 8, 16 * rc, l);"
# "cluster": a head's hd / VT blocks form one cluster; each computes q K^T
# over its own VT key columns, and the shares are summed in rank order
# through distributed shared memory at the chunk's end
CLUSTER_SUM = """    // P over the cluster: each block's share (its VT key columns) through
    // shared memory, summed in rank order, so every block gets the same bits
    const auto cluster = cooperative_groups::this_cluster();
    const auto px = [](int t, int s) { return t * CH + (s ^ 8 * (t & 3)); };
#pragma unroll
    for (int n = 0; n < 4; ++n)
#pragma unroll
      for (int i2 = 0; i2 < 2; ++i2) {
        const int t = 16 * rg + l.g + 8 * i2, s = 32 * half + 8 * n + 2 * l.t;
        *reinterpret_cast<float2*>(Ps + px(t, s)) = make_float2(P[n][2 * i2], P[n][2 * i2 + 1]);
      }
    cluster.sync();                   // every share is written
#pragma unroll
    for (int n = 0; n < 4; ++n)
#pragma unroll
      for (int i2 = 0; i2 < 2; ++i2) {
        const int t = 16 * rg + l.g + 8 * i2, s = 32 * half + 8 * n + 2 * l.t;
        float2 sum = make_float2(0.f, 0.f);
        for (int r = 0; r < int(gridDim.x); ++r) {
          const float* rs = cluster.map_shared_rank(Ps, r);
          const float2 x = *reinterpret_cast<const float2*>(rs + px(t, s));
          sum.x += x.x;
          sum.y += x.y;
        }
        P[n][2 * i2] = sum.x;
        P[n][2 * i2 + 1] = sum.y;
      }
    cluster.sync();                   // every block's reads are done: Ps takes P'
"""
CLUSTER_LAUNCH = """  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(a.hd / VT, B * a.H);
  cfg.blockDim = dim3(NT);
  cfg.dynamicSmemBytes = smem;
  cfg.stream = stream;
  err = cudaFuncSetAttribute(mlstm_tf32_kernel<T, VT>,
                             cudaFuncAttributeNonPortableClusterSizeAllowed, 1);
  if (err != cudaSuccess) return err;
  cudaLaunchAttribute cluster[1];
  cluster[0].id = cudaLaunchAttributeClusterDimension;
  cluster[0].val.clusterDim.x = a.hd / VT;
  cluster[0].val.clusterDim.y = 1;
  cluster[0].val.clusterDim.z = 1;
  cfg.attrs = cluster;
  cfg.numAttrs = 1;
  err = cudaLaunchKernelEx(&cfg, mlstm_tf32_kernel<T, VT>, a);
  if (err != cudaSuccess) return err;
"""
EPILOGUE = "    // P' = P / sqrt(hd) . D in f32 into Ps"
# the shares left at the chunk's end join before the epilogue
CHUNK_JOIN = (EPILOGUE, "    join_shares();\n" + EPILOGUE)
IT_MMA = "          mma3(It[n], fq, fh, fl);\n        }\n"
MID_UPDATE = ("      __syncthreads();                  // every reader of this slice's C_in "
              "and n_in is done\n      update(j, i, nacc);\n")
EPI_BARRIER = ("    __syncthreads();                    // P', its row sums and n_in . q are "
               "written\n")
MMA3 = "  mma(d, a.lo, bh[0], bh[1]);\n  mma(d, a.hi, bl[0], bl[1]);\n"
XOR_ALL = " ^ ".join([f"a.{h}[{i}]" for h in ("hi", "lo") for i in range(4)] +
                     ["bh[0]", "bh[1]", "bl[0]", "bl[1]"])
VARIANTS = {
    "kept": [],
    "vw-regs": [("      if (j == 0) cscale = misc[1];\n",
                 "      if (j == 0) {\n        cscale = misc[1];\n#pragma unroll\n"
                 f"        for (int ks = 0; ks < CH / 8; ++ks) vw[ks] = {VW[16:]}\n"
                 "      }\n"),
                ("    float cscale = 0.f;\n", "    float cscale = 0.f;\n    Frag vw[CH / 8];\n"),
                (VW, "const Frag& fa = vw[ks];")],
    "vt32": [("hd % 64 == 0 ? launch<T, 64>(a, B, stream) : launch<T, 32>(a, B, stream)",
              "launch<T, 32>(a, B, stream)")],
    "cluster": [("#include <stdint.h>\n", "#include <cooperative_groups.h>\n#include <stdint.h>\n"),
                ("        if (p_live) {",
                 "        if (p_live && j / (VT / KS) == int(blockIdx.x)) {"),
                (EPILOGUE, CLUSTER_SUM + EPILOGUE),
                ("  mlstm_tf32_kernel<T, VT><<<dim3(a.hd / VT, B * a.H), NT, smem, stream>>>(a);\n",
                 CLUSTER_LAUNCH)],
    "deferred": [(MID_UPDATE, "      if (j > 0) update(j - 1, i - 1, nsum);\n      nsum = nacc;\n"),
                 ("    float cscale = 0.f;\n", "    float cscale = 0.f, nsum = 0.f;\n"),
                 (EPI_BARRIER, EPI_BARRIER + "    update(NSL - 1, ci * NSL + NSL - 1, nsum);\n")],
    "join-8": [(IT_MMA + "      }\n      join_shares();\n",
                IT_MMA + "        join_shares();\n      }\n")],
    "join-128": [("      join_shares();\n", "      if (j % 4 == 3) join_shares();\n"), CHUNK_JOIN],
    "join-chunk": [("      join_shares();\n", ""), CHUNK_JOIN],
    "kc-unroll1": [(KC, KC.replace("unroll", "unroll 1", 1))],
    "no-split": [("  hi = rna(x);\n  lo = rna(x - __uint_as_float(hi));",
                  "  hi = lo = __float_as_uint(x);")],
    "one-mma": [(MMA3, "")],
    "p-none": [("const bool p_live = 32 * half <= 16 * rg + 15;", "const bool p_live = false;")],
    "no-mma": [(MMA3 + "  mma(d, a.hi, bh[0], bh[1]);\n",
                f"  d[0] += __uint_as_float({XOR_ALL});\n")],
}
# (tag, B, S, H, hd): xlstm-350m's prefill shape, and head dim 64 at its inner width
SHAPES = [("B8 S4096 H4 hd512", 8, 4096, 4, 512), ("B8 S4096 H32 hd64", 8, 4096, 32, 64)]


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
    from repro_torch.kernels.mlstm.ref import mlstm_chunkwise_ref
    from tools.flash_bwd_variants import build

    if not torch.cuda.is_available():
        print("mlstm_variants: no CUDA device", file=sys.stderr)
        return 2
    torch.backends.cuda.matmul.allow_tf32 = False
    names = args.only.split(",") if args.only else list(VARIANTS)
    libs = build(_build.BUILD_DIR / "mlstm_variants", names, "mlstm.cu", VARIANTS,
                 ("repro_mlstm",), "_tf32_")
    gen = torch.Generator(device="cuda").manual_seed(0)
    flush = torch.empty(256 * 2**20, dtype=torch.uint8, device="cuda")
    cases = []
    for tag, B, S, H, hd in SHAPES:
        q, k, v, g, _ = cs._mlstm_inputs(gen, B, S, H, hd, torch.float32)
        h, st = mlstm_chunkwise_ref(q, k, v, g, None, 256)
        h64 = cs._mlstm_f64(q, k, v, g)
        print(f"[mlstm_variants] {tag}: the plain form's h off the f64 recurrence, worst error / "
              f"limit {cs.limit_frac(h, h64, cs.MLSTM_MAIN_STATE_TOL):.3f}", flush=True)
        cases.append((tag, (q, k, v, g), (h, *st), h64))
    times = {(name, tag): [] for name in libs for tag, *_ in cases}
    for rnd in range(args.rounds):
        # in turns, the order reversed every other round (a variant's place
        # in a round moved its time by ~3% on an H100)
        for name, lib in list(libs.items())[::-1 if rnd % 2 else 1]:
            _build._lib = lib          # the port's wrapper launches this variant
            for tag, a, ref, h64 in cases:
                h, st = kernel.mlstm_tf32(*a)
                torch.cuda.synchronize()
                worst = {key: cs.limit_frac(x, r, cs.MLSTM_M_TOL if key == "m" else
                                            cs.MLSTM_MAIN_STATE_TOL)
                         for key, x, r in zip("hCnm", (h, *st), ref)}
                worst["h vs f64"] = cs.limit_frac(h, h64, cs.MLSTM_MAIN_STATE_TOL)
                del h, st
                tt = cs.time_each(lambda: kernel.mlstm_tf32(*a), flush, reps=args.reps)
                times[name, tag] += tt
                print(f"[mlstm_variants] {name} (round {rnd}) {tag}: {cs.fmt_spread(tt)}; "
                      "worst error / limit " + ", ".join(f"{k} {v:.3f}" for k, v in worst.items()),
                      flush=True)
    for (name, tag), t in times.items():
        print(f"[mlstm_variants] {name} {tag}, all rounds: {cs.fmt_spread(t)}")
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True).stdout.strip())
    return 0


if __name__ == "__main__":
    sys.exit(main())
