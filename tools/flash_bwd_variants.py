#!/usr/bin/env python3
"""Time text-patched variants of the port's f32 flash backward on one card.

    python3 tools/flash_bwd_variants.py [--reps 2] [--only kept,cvt]

Each variant is ``src/repro_torch/csrc/flash_attention_bwd.cu`` (and the
split-TF32 helpers it includes, ``csrc/tf32.cuh``) with a few lines
replaced, compiled on its own (one nvcc each, in parallel) and
called through the port's wrappers on f32 inputs at the port's f32
training shapes (``SHAPES``; o and lse from the forward kernel, as
``chip_smoke.py`` makes them). For each: the split-TF32 dk/dv's and dq's
time (CUDA events, L2 flushed before each call) and their largest errors
against ``attention_bwd_ref`` (a variant that drops arithmetic is wrong by
design; its time says what the rest costs). The variants:

* ``kept``: the source as it is;
* ``cvt``: rna by the ``cvt.rna.tf32.f32`` instruction in place of the
  integer add and mask;
* ``lo-raw``: lo = x - hi handed to the tensor cores as it is, which read
  its top 19 bits (truncation in place of rna);
* ``no-split``: x handed over as hi and as lo, with no arithmetic: the
  split's cost (wrong by design);
* ``one-mma``: only a_hi b_hi of the three products (wrong by design);
* ``one-sum``: each gradient summed in its one accumulator on the tensor
  cores, with no tile share added by an f32 add (the tensor cores'
  rounding toward zero then drifts);
* ``ng4``: dk/dv takes a tile's share over 4 column blocks at a time,
  not 2 (more independent products in flight, more registers);
* ``bq32``: dk/dv streams 32-row q tiles (16 a warp) up to hd 128.

Needs a CUDA device and nvcc, as the port's build does; prints one line
per variant, shape and round, then the card's name and power limit.
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

RNA = "  return (__float_as_uint(x) + 0x1000u) & 0xffffe000u;"
VARIANTS = {
    "kept": [],
    "cvt": [(RNA, '  uint32_t r;\n  asm("cvt.rna.tf32.f32 %0, %1;" : "=r"(r) : "f"(x));\n'
                  "  return r;")],
    "lo-raw": [("  lo = rna(x - __uint_as_float(hi));",
                "  lo = __float_as_uint(x - __uint_as_float(hi));")],
    "no-split": [("  hi = rna(x);\n  lo = rna(x - __uint_as_float(hi));",
                  "  hi = lo = __float_as_uint(x);")],
    "one-mma": [("  mma(d, a.lo, bh[0], bh[1]);\n  mma(d, a.hi, bl[0], bl[1]);\n", "")],
    "one-sum": [
        ("          for (int e = 0; e < 4; ++e) tv[j][e] = tk[j][e] = 0.f;",
         "          for (int e = 0; e < 4; ++e) {\n"
         "            tv[j][e] = dv[n0 + j][e];\n            tk[j][e] = dk[n0 + j][e];\n          }"),
        ("          add(dv[n0 + j], tv[j]);\n          add(dk[n0 + j], tk[j]);",
         "          for (int e = 0; e < 4; ++e) {\n"
         "            dv[n0 + j][e] = tv[j][e];\n            dk[n0 + j][e] = tk[j][e];\n          }"),
        ("          for (int e = 0; e < 4; ++e) t[j][e] = 0.f;",
         "          for (int e = 0; e < 4; ++e) t[j][e] = dq[n0 + j][e];"),
        ("        for (int j = 0; j < NG; ++j) add(dq[n0 + j], t[j]);",
         "        for (int j = 0; j < NG; ++j)\n"
         "          for (int e = 0; e < 4; ++e) dq[n0 + j][e] = t[j][e];")],
    "ng4": [("static constexpr int NG = 2;", "static constexpr int NG = 4;")],
    "bq32": [("static constexpr int BQ = SPLIT ? 16 : 64;",
              "static constexpr int BQ = SPLIT ? 16 : 32;")],
}
# (B, S, H, KVH, hd, window): qwen3-4b's attention at S 1000, gemma-7b's,
# whisper-tiny's training, hymba-1.5b's training at S 1500 (chip_smoke.py)
SHAPES = [(1, 1000, 32, 8, 128, 0), (1, 1000, 16, 16, 256, 0), (4, 448, 6, 6, 64, 0),
          (1, 1500, 25, 5, 64, 1024)]


def build(out: Path, names, source: str = "flash_attention_bwd.cu", variants=None,
          entries=("repro_flash_attention_bwd_dkdv", "repro_flash_attention_bwd_dq"),
          tag: str = "_tf32_", csrc: Path = None) -> dict:
    """Compile the variants of ``source`` (in parallel; a patch applies to the
    source or to the header ``tf32.cuh``, whichever holds its text), from
    ``csrc`` (default: this checkout's sources); return {name: loaded library
    with ``entries`` bound}. ptxas of the entry functions whose name holds
    ``tag`` is printed."""
    from repro_torch.kernels import _build

    variants = VARIANTS if variants is None else variants
    csrc = _build.CSRC if csrc is None else Path(csrc)
    headers = ("common.cuh", "hopper.cuh", "tf32.cuh")
    texts = {f: (csrc / f).read_text() for f in (source, *headers)}
    procs = {}
    for name in names:
        d = out / name
        d.mkdir(parents=True, exist_ok=True)
        files = dict(texts)
        for old, new in variants[name]:
            where = [f for f in (source, "tf32.cuh") if old in files[f]]
            if not where:
                raise RuntimeError(f"variant {name}: {old!r} is not in {source} or tf32.cuh")
            files[where[0]] = files[where[0]].replace(old, new)
        for f, text in files.items():
            (d / f).write_text(text)
        shutil.copy(csrc / "errors.cu", d / "errors.cu")
        cmd = [_build.nvcc_path(), *_build.NVCC_FLAGS, "-shared", "-o", str(d / "lib.so"),
               str(d / source), str(d / "errors.cu")]
        procs[name] = subprocess.Popen(cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
                                       text=True)
    libs = {}
    for name, proc in procs.items():
        log, _ = proc.communicate()
        if proc.returncode:
            raise RuntimeError(f"variant {name} did not build:\n{log}")
        regs = [(e.split("'", 1)[0].split(tag.strip("_"))[-1][:24],
                 re.search(r"Used (\d+) registers", e).group(1),
                 re.search(r"(\d+) bytes spill stores", e).group(1))
                for e in log.split("Compiling entry function '")[1:] if tag in e[:200]]
        print(f"[{Path(sys.argv[0]).stem}] {name} built; ptxas (kernel, registers, spill "
              f"stores): {regs}", flush=True)
        lib = ctypes.CDLL(str(out / name / "lib.so"))
        for fn in entries:
            getattr(lib, fn).argtypes = _build.SIGNATURES[fn]
            getattr(lib, fn).restype = ctypes.c_int
        lib.repro_error_string.argtypes = [ctypes.c_int]
        lib.repro_error_string.restype = ctypes.c_char_p
        libs[name] = lib
    return libs


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--reps", type=int, default=2, help="rounds over the variants")
    ap.add_argument("--only", default="", help="comma-separated variants (default: all)")
    args = ap.parse_args()
    sys.path[:0] = [str(REPO / "src"), str(REPO)]
    import torch

    import chip_smoke as cs
    from repro_torch.kernels import _build
    from repro_torch.kernels.flash_attention import kernel, kernel_bwd
    from repro_torch.kernels.flash_attention.ref import attention_bwd_ref

    if not torch.cuda.is_available():
        print("flash_bwd_variants: no CUDA device", file=sys.stderr)
        return 2
    names = args.only.split(",") if args.only else list(VARIANTS)
    _build.load()                      # the forward kernel that makes o and lse
    lib0 = _build._lib
    libs = build(_build.BUILD_DIR / "flash_bwd_variants", names)
    gen = torch.Generator(device="cuda").manual_seed(0)
    flush = torch.empty(256 * 2**20, dtype=torch.uint8, device="cuda")
    cases = []
    for B, S, H, KVH, hd, window in SHAPES:
        mk = lambda heads: torch.randn((B, S, heads, hd), generator=gen, device="cuda")
        q, k, v, do = mk(H), mk(KVH), mk(KVH), mk(H)
        kw = dict(causal=True, window=window, q_offset=0)
        _build._lib = lib0
        o, lse = kernel.flash_attention_fwd(q, k, v, **kw)
        delta = (do * o).sum(-1).transpose(1, 2).contiguous()
        ref = attention_bwd_ref(q, k, v, o, lse, do, **kw)
        cases.append((f"B{B} S{S} H{H}/{KVH} hd{hd} w{window}", (q, k, v, do, lse, delta), kw,
                      ref))
    for rnd in range(args.reps):
        for name, lib in libs.items():
            _build._lib = lib          # the port's wrappers launch this variant
            for tag, a, kw, (rq, rk, rv) in cases:
                dk, dv = kernel_bwd.flash_attention_bwd_dkdv(*a, **kw)
                dq = kernel_bwd.flash_attention_bwd_dq(*a, **kw)
                torch.cuda.synchronize()
                err = {n: cs.within(x, r, cs.FLASH_BWD_F32_TOL) for n, x, r in
                       (("dk", dk, rk), ("dv", dv, rv), ("dq", dq, rq))}
                t_kv = cs.time_ms(lambda: kernel_bwd.flash_attention_bwd_dkdv(*a, **kw), flush)
                t_q = cs.time_ms(lambda: kernel_bwd.flash_attention_bwd_dq(*a, **kw), flush)
                print(f"[flash_bwd_variants] {name} (round {rnd}) {tag}: dkdv {t_kv:.4f} ms, "
                      f"dq {t_q:.4f} ms; max err (within FLASH_BWD_F32_TOL) " +
                      ", ".join(f"{n} {e:.3e} ({ok})" for n, (e, ok) in err.items()), flush=True)
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True).stdout.strip())
    return 0


if __name__ == "__main__":
    sys.exit(main())
