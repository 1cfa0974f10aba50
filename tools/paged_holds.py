#!/usr/bin/env python3
"""Probe ``chip_smoke.py``'s mean-error hold on the bf16 paged kernels.

    python3 tools/paged_holds.py --emulate      # on the CPU: the hold's prediction
    python3 tools/paged_holds.py --mutant lo    # on one card: a patched kernel's holds

The bf16 split kernels keep p as hi + lo bf16 halves in P.V
(``csrc/paged_attention.cu``, ``paged_split_tc_kernel``). Without the lo
half each weight moves by up to 2^-9 of itself, below
``PAGED_MAIN_BF16_TOL``. ``chip_smoke.py::hold_mean_err`` holds the
kernel's mean |error| against the f32 version on the same bf16 inputs to
``PAGED_MEAN_ERR_MARGIN`` x that of the plain split form in bf16.

``--emulate``: the split kernel's arithmetic in f32 on the CPU (128-position
segments, exact softmax, P.V with p as hi + lo, or as hi alone, the merge
in segment order, the output rounded to bf16) at the main-path shapes
``chip_smoke.py`` holds (8 lanes, H32/8 and H40/40, hd 128); prints each
mean error's ratio to the plain split form's.

``--mutant lo``: copies ``src/`` and ``chip_smoke.py`` to a temporary
directory, patches ``csrc/paged_attention.cu`` to drop the lo half's
product, builds there and runs ``check_paged`` and ``check_paged_int8``
with every hold counted instead of raising; prints the mean-error holds'
and ``hold_no_farther``'s numbers, each failed tolerance hold and the
count. It first prints the card's name and power limit.
"""
from __future__ import annotations

import argparse
from pathlib import Path
import shutil
import subprocess
import sys
import tempfile

import numpy as np

ROOT = Path(__file__).resolve().parents[1]
# the second of P.V's two products: p's lo half
MUTANTS = {"lo": ("        mma16816(o[j], l0, l2, vb[0], vb[1]);\n", "")}
MAIN_SHAPES = [(32, 8), (40, 40)]     # (H, KVH) at 8 lanes, hd 128, pages of 16, 128 a lane


def _inputs(torch, H, KVH, seed=1):
    rng = np.random.RandomState(seed)
    B, hd, ps, mb = 8, 128, 16, 128
    lens = [2048] + np.random.RandomState(1).randint(1, 2049, 7).tolist()
    P = B * mb + 1
    draw = lambda *s: torch.from_numpy(rng.randn(*s).astype(np.float32)).to(torch.bfloat16)
    q, kp, vp = draw(B, H, hd), draw(P, ps, KVH, hd), draw(P, ps, KVH, hd)
    perm = rng.permutation(B * mb)
    table = np.full((B, mb), -1, np.int32)
    for b, n in enumerate(lens):
        used = -(-n // ps)
        table[b, :used] = perm[b * mb: b * mb + used]
    return q, kp, vp, torch.from_numpy(table), torch.as_tensor(lens, dtype=torch.int32)


def _emulated(torch, q, kp, vp, table, lens, lo: bool):
    """The bf16 split kernel's arithmetic, in f32 on the CPU."""
    B, H, hd = q.shape
    P, ps, KVH, _ = kp.shape
    G, T = H // KVH, table.shape[1] * ps
    tbl = table.clamp(0, P - 1).long()
    k = kp[tbl].reshape(B, T, KVH, hd).float()
    v = vp[tbl].reshape(B, T, KVH, hd).float()
    qg = q.reshape(B, KVH, G, hd).float() * float(hd ** -0.5)
    out = torch.zeros(B, KVH, G, hd)
    for b in range(B):
        n, parts = int(lens[b]), []
        for j in range(-(-n // 128)):
            kb, vb = k[b, j * 128: min(n, (j + 1) * 128)], v[b, j * 128: min(n, (j + 1) * 128)]
            s = torch.einsum("kgd,tkd->kgt", qg[b], kb)
            m = s.amax(-1)
            p = torch.exp(s - m[..., None])
            hi = p.bfloat16().float()
            acc = torch.einsum("kgt,tkd->kgd", hi, vb)
            if lo:
                acc = acc + torch.einsum("kgt,tkd->kgd", (p - hi).bfloat16().float(), vb)
            parts.append((m, p.sum(-1), acc))
        M = torch.stack([m for m, _, _ in parts]).amax(0)
        L, A = 0.0, 0.0
        for m, l, a in parts:
            w = torch.exp(m - M)
            L, A = L + l * w, A + a * w[..., None]
        out[b] = A / L[..., None]
    return out.reshape(B, H, hd).bfloat16()


def emulate() -> None:
    import torch

    sys.path.insert(0, str(ROOT / "src"))
    from repro_torch.kernels.paged_attention.ref import (paged_attention_ref,
                                                         paged_attention_split_ref)

    for H, KVH in MAIN_SHAPES:
        args = _inputs(torch, H, KVH)
        q, kp, vp, table, lens = args
        ref32 = paged_attention_ref(q.float(), kp.float(), vp.float(), table, lens)
        err = lambda o: float((o.float() - ref32).abs().mean())
        plain = err(paged_attention_split_ref(*args))
        for lo in (True, False):
            e = err(_emulated(torch, *args, lo=lo))
            print(f"8 lanes H{H}/{KVH} hd128, p as {'hi + lo' if lo else 'hi alone'}: mean abs "
                  f"error {e:.6e}, the plain split form's {plain:.6e}: {e / plain:.6f}x",
                  flush=True)


def mutant(name: str) -> None:
    tmp = Path(tempfile.mkdtemp(prefix=f"paged_mutant_{name}_"))
    try:
        shutil.copytree(ROOT / "src", tmp / "src", ignore=shutil.ignore_patterns("__pycache__"))
        shutil.copy(ROOT / "chip_smoke.py", tmp)
        cu = tmp / "src/repro_torch/csrc/paged_attention.cu"
        old, new = MUTANTS[name]
        text = cu.read_text()
        if text.count(old) != 1:
            raise SystemExit(f"mutant {name}: the line to patch is not in paged_attention.cu once")
        cu.write_text(text.replace(old, new))
        sys.path[:0] = [str(tmp / "src"), str(tmp)]
        import torch
        import chip_smoke as cs
        from repro_torch.kernels import _build

        torch.backends.cuda.matmul.allow_tf32 = False
        torch.backends.cudnn.allow_tf32 = False
        _build.build()
        _build.load()
        counts = {"ok": 0, "failed": 0}

        def hold(tag, out, ref, t):
            err, ok = cs.within(out, ref, t)
            counts["ok" if ok else "failed"] += 1
            if not ok:
                print(f"  FAIL {tag}: {err:.3e}", flush=True)
            return err

        def counted(fn):
            def run(*args):
                try:
                    fn(*args)
                    counts["ok"] += 1
                except AssertionError:
                    counts["failed"] += 1
            return run

        cs.hold = hold
        cs.hold_mean_err = counted(cs.hold_mean_err)
        cs.hold_no_farther = counted(cs.hold_no_farther)
        # the two relative holds print their numbers; nothing else does
        cs.log = lambda msg: print(msg, flush=True) if "against f32" in msg else None
        gen = torch.Generator(device="cuda").manual_seed(0)
        flush = torch.empty(256 * 2**20, dtype=torch.uint8, device="cuda")
        for check in (cs.check_paged, cs.check_paged_int8):
            try:
                check(gen, flush)
            except AssertionError as e:
                counts["failed"] += 1
                print(f"  FAIL (raised) {e}", flush=True)
        print(f"mutant {name}: holds {counts}", flush=True)
    finally:
        shutil.rmtree(tmp, ignore_errors=True)


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--emulate", action="store_true", help="the CPU emulation only")
    ap.add_argument("--mutant", choices=sorted(MUTANTS))
    args = ap.parse_args()
    if args.emulate:
        emulate()
        return 0
    if not args.mutant:
        ap.error("give --emulate or --mutant")
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True)
    print(smi.stdout.strip(), flush=True)
    mutant(args.mutant)
    return 0


if __name__ == "__main__":
    sys.exit(main())
