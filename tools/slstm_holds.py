#!/usr/bin/env python3
"""Probe ``chip_smoke.py``'s sLSTM holds on one card.

    python3 tools/slstm_holds.py --draws 3        # margins of the holds
    python3 tools/slstm_holds.py --mutant dm      # a patched kernel: holds failed

``--draws N``: the backward's small cases (``SLSTM_CASES`` at d 128, with
and without a start state) on the draw ``chip_smoke.py`` makes (after
``check_slstm``) and on N more seeds. For each output it prints the worst
share of ``SLSTM_TOL``'s limit taken by the kernel's distance from the
plain f32 version, and the kernel's and the plain version's largest error
against an f64 witness with their ratio; then the largest share and ratio
by sequence length and output.

``--mutant NAME``: copies ``src/`` and ``chip_smoke.py`` to a temporary
directory, patches one line of ``csrc/slstm.cu`` (``MUTANTS``: ``dm``, the
backward without its dm chain; ``h0``, the forward staging only 128 units
of the start state's h; ``wait``, the forward reading the exchanged h
without waiting for its step's tag; ``bwait``, the backward reading the
exchanged shares of dpre r^T without waiting for their tag), builds there
and runs
``check_slstm`` and ``check_slstm_bwd`` with every hold counted instead of
raising. Prints each failed hold and the count.

Either prints the card's name and power limit first.
"""
from __future__ import annotations

import argparse
import collections
import os
from pathlib import Path
import shutil
import subprocess
import sys
import tempfile

ROOT = Path(__file__).resolve().parents[1]
MUTANTS = {
    # the backward drops the dm chain
    "dm": ("        stw[2 * BU + si] = da;", "        stw[2 * BU + si] = 0.f;"),
    # the forward stages only the first 128 units of the start state's h
    "h0": ("          Hw[j * ks + k] = a.h0 ? a.h0[(long long)(b0 + j) * d + kb + k] : 0.f;",
           "          Hw[j * ks + k] = a.h0 && kb + k < 128 ? a.h0[(long long)(b0 + j) * d + kb + k]"
           " : 0.f;"),
    # the forward reads the exchanged h without waiting for its step's tag
    "wait": ("            pending = untagged(lines, pending, want);",
             "            pending = 0;"),
    # the backward reads the exchanged shares of dpre_{t+1} r^T (and dh0's of
    # dpre_0 r^T) without waiting for their tag
    "bwait": ("        pending = untagged(L, pending, want);", "        pending = 0;"),
}
NAMES = ("dwx", "dr", "dc0", "dn0", "dh0", "dm0")


def _setup(tree: Path):
    os.chdir(tree)
    sys.path[:0] = [str(tree / "src"), str(tree)]
    import torch
    import chip_smoke as cs
    from repro_torch.kernels import _build

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    _build.build()
    _build.load()
    flush = torch.empty(256 * 2**20, dtype=torch.uint8, device="cuda")
    return torch, cs, flush


def draws(n: int) -> None:
    torch, cs, flush = _setup(ROOT)
    from repro_torch.kernels.slstm import kernel
    from repro_torch.kernels.slstm.ref import slstm_bwd_ref

    f64 = lambda ts: None if ts is None else tuple(t.double() for t in ts)
    flat = lambda out: (out[0], out[1], *(out[2] or ()))
    worst = collections.defaultdict(lambda: [0.0, 0.0])
    tol = cs.SLSTM_TOL

    def run(gen, label):
        rnd = lambda *shape: torch.randn(shape, generator=gen, device="cuda")
        for B, S in cs.SLSTM_CASES:
            for with_state in (False, True):
                wx, r, state = cs._slstm_inputs(gen, B, S, cs.SLSTM_D, with_state)
                hs, _, kept = kernel.slstm(wx, r, state, keep=True)
                dhs = rnd(B, S, cs.SLSTM_D)
                dfin = tuple(rnd(B, cs.SLSTM_D) for _ in range(4)) if with_state else None
                got = kernel.slstm_bwd(r, state, hs, kept, dhs, dfin)
                want = slstm_bwd_ref(r, state, hs, kept, dhs, dfin)
                wit = slstm_bwd_ref(r.double(), f64(state), hs.double(), f64(kept),
                                    dhs.double(), f64(dfin))
                for name, a, b, w in zip(NAMES, flat(got), flat(want), flat(wit)):
                    share = float(((a - b).abs() / (tol["atol"] + tol["rtol"] * b.abs())).max())
                    ek = float((a.double() - w).abs().max())
                    ep = float((b.double() - w).abs().max())
                    ratio = ek / ep if ep else 0.0
                    key = (S, name)
                    worst[key] = [max(worst[key][0], share), max(worst[key][1], ratio)]
                    print(f"{label} B{B} S{S}{' with state' if with_state else ''} {name}: "
                          f"|kernel - plain| {float((a - b).abs().max()):.3e}, share of "
                          f"SLSTM_TOL's limit {share:.3f}; off the f64 witness: kernel {ek:.3e}, "
                          f"plain f32 {ep:.3e}, ratio {ratio:.3f}", flush=True)

    gen = torch.Generator(device="cuda").manual_seed(0)
    cs.log = lambda *a, **k: None
    cs.check_slstm(gen, flush)              # chip_smoke's draw continues from here
    run(gen, "chip_smoke's draw")
    for seed in range(1, n + 1):
        run(torch.Generator(device="cuda").manual_seed(seed), f"seed {seed}")
    for (S, name), (share, ratio) in sorted(worst.items()):
        print(f"S{S} {name}: largest share of SLSTM_TOL's limit {share:.3f}, largest ratio to "
              f"the plain f32's error off the witness {ratio:.3f}")


def mutant(name: str) -> None:
    tmp = Path(tempfile.mkdtemp(prefix=f"slstm_mutant_{name}_"))
    try:
        shutil.copytree(ROOT / "src", tmp / "src", ignore=shutil.ignore_patterns("__pycache__"))
        shutil.copy(ROOT / "chip_smoke.py", tmp)
        cu = tmp / "src/repro_torch/csrc/slstm.cu"
        old, new = MUTANTS[name]
        text = cu.read_text()
        if text.count(old) != 1:
            raise SystemExit(f"mutant {name}: the line to patch is not in slstm.cu once")
        cu.write_text(text.replace(old, new))
        torch, cs, flush = _setup(tmp)
        counts = {"ok": 0, "failed": 0}
        wit0 = cs._slstm_vs_witness

        def hold(tag, out, ref, t):
            err, ok = cs.within(out, ref, t)
            counts["ok" if ok else "failed"] += 1
            if not ok:
                print(f"  FAIL {tag}: {err:.3e}", flush=True)
            return err

        def witness(tag, got, plain, w, names, failed):
            mine = []
            worst = wit0(tag, got, plain, w, names, mine)
            counts["failed"] += len(mine)
            counts["ok"] += len(names) - len(mine)
            for m in mine:
                print(f"  FAIL {m} (f64 witness)", flush=True)
            return worst

        cs.hold, cs._slstm_vs_witness = hold, witness
        cs.log = lambda *a, **k: None
        gen = torch.Generator(device="cuda").manual_seed(0)
        for check in (cs.check_slstm, cs.check_slstm_bwd):
            try:
                check(gen, flush)
            except AssertionError as e:
                counts["failed"] += 1
                print(f"  FAIL (raised) {e}", flush=True)
        print(f"mutant {name}: holds {counts}")
    finally:
        shutil.rmtree(tmp, ignore_errors=True)


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--draws", type=int, default=None, help="seeds beyond chip_smoke's draw")
    ap.add_argument("--mutant", choices=sorted(MUTANTS))
    args = ap.parse_args()
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True)
    print(smi.stdout.strip(), flush=True)
    if args.mutant:
        mutant(args.mutant)
    else:
        draws(3 if args.draws is None else args.draws)
    return 0


if __name__ == "__main__":
    sys.exit(main())
