"""Roofline over the dry run's records for one H100: the counterpart of the
reference's ``launch/roofline.py``, with NVIDIA H100 80GB HBM3 constants
(the data sheet's, at its 700 W limit) in place of the v5e ones:

    compute    = sum over dtypes of FLOPs / that dtype's peak
                 (bf16 989 TFLOP/s, split TF32 495/3, f32 FMA 67)
    memory     = bytes / 3.35 TB/s
    collective = wire bytes / 450 GB/s (NVLink, each way): 0 on one card

plus MODEL_FLOPS (6·N_active·D training, 2·N_active·D serving), the useful
ratio MODEL / counted FLOPs, the dominant term, the roofline fraction
(ideal useful-compute time at the bf16 peak over the dominant term's
time) and the peak against the card's 80 GiB. These are estimates from
``launch/dryrun.py``'s counts, not measurements.

    python -m repro_torch.launch.roofline [--markdown] [--compare]
"""
from __future__ import annotations

import argparse
import json
import pathlib
from typing import Dict, List

from repro_torch.config import get_arch, get_shape
from repro_torch.launch.dryrun import MESH, RESULTS_DIR

H100 = "NVIDIA H100 80GB HBM3, 700.00 W"
PEAKS = {"bf16": 989e12, "f16": 989e12, "tf32x3": 495e12 / 3}
F32_FMA_FLOPS = 67e12          # every other dtype's operations
HBM_BANDWIDTH = 3.35e12
NVLINK_BW = 450e9
HBM_BYTES = 80 * 1024**3
CHIPS = {MESH: 1}


def model_flops(arch: str, shape_name: str) -> float:
    """Useful FLOPs per step, GLOBAL (6·N·D train, 2·N·D serving)."""
    cfg = get_arch(arch)
    shape = get_shape(shape_name)
    n_active = cfg.active_param_count()
    if shape.mode == "train":
        tokens = shape.global_batch * shape.seq_len
        return 6.0 * n_active * tokens
    if shape.mode == "prefill":
        tokens = shape.global_batch * shape.seq_len
        return 2.0 * n_active * tokens
    # decode: one token per sequence
    return 2.0 * n_active * shape.global_batch


def compute_seconds(flops_by_dtype: Dict[str, float]) -> float:
    return sum(n / PEAKS.get(dtype, F32_FMA_FLOPS) for dtype, n in flops_by_dtype.items())


def analyze_cell(rec: Dict) -> Dict:
    chips = CHIPS[rec["mesh"]]
    t_compute = compute_seconds(rec["flops_by_dtype"])
    t_memory = rec["hbm_bytes"] / HBM_BANDWIDTH
    t_coll = rec["collective_wire_bytes"] / NVLINK_BW
    terms = {"compute": t_compute, "memory": t_memory, "collective": t_coll}
    dominant = max(terms, key=terms.get)
    mf_global = model_flops(rec["arch"], rec["shape"])
    mf_dev = mf_global / chips
    useful_ratio = mf_dev / rec["flops"] if rec["flops"] else 0.0
    t_ideal = mf_dev / PEAKS["bf16"]
    frac = t_ideal / max(terms.values()) if max(terms.values()) > 0 else 0.0

    notes = {
        "compute": "cut non-useful FLOPs (remat policy, triangular attention, f32 products)",
        "memory": "fuse the elementwise tail and keep intermediates on chip (kernels)",
        "collective": "reshard to cut gathers (more than one card)",
    }
    return {
        **{k: rec[k] for k in ("arch", "shape", "mode", "mesh", "layout")},
        "microbatches": rec.get("microbatches", 1),
        "t_compute_s": t_compute,
        "t_memory_s": t_memory,
        "t_collective_s": t_coll,
        "t_roofline_s": max(terms.values()),
        "dominant": dominant,
        "model_flops_global": mf_global,
        "useful_ratio": useful_ratio,
        "roofline_fraction": frac,
        "peak_gib": rec.get("peak_bytes_per_device", 0) / 2**30,
        "fits": rec.get("peak_bytes_per_device", 0) <= HBM_BYTES,
        "note": notes[dominant],
    }


def load(mesh: str = MESH, results_dir: pathlib.Path = RESULTS_DIR) -> List[Dict]:
    out = []
    for f in sorted(results_dir.glob("*.json")):
        rec = json.loads(f.read_text())
        if rec["mesh"] == mesh:
            out.append(analyze_cell(rec))
    return out


OPTIMIZED_LAYOUTS = ("tri_bigchunk", "tri_gather_bigchunk", "bigchunk", "triangular")


def compare(mesh: str = MESH) -> None:
    """Baseline vs best optimized layout per cell."""
    rows = load(mesh)
    by_cell: Dict = {}
    for r in rows:
        by_cell.setdefault((r["arch"], r["shape"]), {})[r["layout"]] = r
    hdr = (f"{'arch':22s} {'shape':12s} {'base_bound':>10s} {'base_roof':>9s} "
           f"{'opt_layout':>20s} {'opt_roof':>8s} {'gain':>6s}")
    print(hdr + "\n" + "-" * len(hdr))
    for (arch, shape), variants in sorted(by_cell.items()):
        base = variants.get("baseline") or variants.get("int8_cache")
        if base is None:
            continue
        opts = [variants[l] for l in OPTIMIZED_LAYOUTS if l in variants]
        if not opts:
            continue
        best = max(opts, key=lambda r: r["roofline_fraction"])
        gain = best["roofline_fraction"] / max(base["roofline_fraction"], 1e-9)
        print(
            f"{arch:22s} {shape:12s} {base['dominant']:>10s} "
            f"{base['roofline_fraction']:9.4f} {best['layout']:>20s} "
            f"{best['roofline_fraction']:8.4f} {gain:5.1f}x"
        )


def markdown(rows: List[Dict]) -> str:
    lines = [
        f"Estimate for one {H100} (`launch/dryrun.py` counts, `launch/roofline.py` terms; "
        f"not measured). Peak against the card's {HBM_BYTES / 2**30:.0f} GiB.",
        "",
        "| arch | shape | layout | t_comp (s) | t_mem (s) | t_coll (s) | bound | useful/counted "
        "| roofline | peak GiB | fits 80 GiB |",
        "|---|---|---|---|---|---|---|---|---|---|---|",
    ]
    for r in rows:
        lines.append(
            f"| {r['arch']} | {r['shape']} | {r['layout']}"
            f"{'/mb' + str(r['microbatches']) if r['microbatches'] > 1 else ''} "
            f"| {r['t_compute_s']:.3e} | {r['t_memory_s']:.3e} | {r['t_collective_s']:.3e} "
            f"| **{r['dominant'][:4]}** | {r['useful_ratio']:.2f} "
            f"| {r['roofline_fraction']:.3f} | {r['peak_gib']:.1f} | "
            f"{'yes' if r['fits'] else 'no'} |"
        )
    return "\n".join(lines)


def main(argv=None) -> None:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--mesh", default=MESH, choices=list(CHIPS))
    ap.add_argument("--markdown", action="store_true")
    ap.add_argument("--compare", action="store_true")
    args = ap.parse_args(argv)
    if args.compare:
        compare(args.mesh)
        return
    rows = load(args.mesh)
    if not rows:
        raise SystemExit(f"no dry-run results for mesh {args.mesh} under {RESULTS_DIR}")
    if args.markdown:
        print(markdown(rows))
        return
    hdr = (f"{'arch':22s} {'shape':12s} {'t_comp':>9s} {'t_mem':>9s} "
           f"{'t_coll':>9s} {'bound':>6s} {'use':>5s} {'roof':>6s} {'peak':>7s}")
    print(hdr + "\n" + "-" * len(hdr))
    for r in rows:
        print(
            f"{r['arch']:22s} {r['shape']:12s} {r['t_compute_s']:9.3e} {r['t_memory_s']:9.3e} "
            f"{r['t_collective_s']:9.3e} {r['dominant'][:6]:>6s} {r['useful_ratio']:5.2f} "
            f"{r['roofline_fraction']:6.3f} {r['peak_gib']:6.1f}G"
        )
    worst = min(rows, key=lambda r: r["roofline_fraction"])
    print(f"worst roofline fraction: {worst['arch']}:{worst['shape']} "
          f"{worst['roofline_fraction']:.4f}")


if __name__ == "__main__":
    main()
