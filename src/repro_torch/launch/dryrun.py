"""Dry run for one H100: trace one step of every (arch x shape) cell on the
meta device through the port's own step builders, and record what it
costs (FLOPs by dtype, bytes, peak live bytes, the kernels' calls). The
counterpart of the reference's ``launch/dryrun.py``, which lowers each
cell to 512 v5e chips and reads the compiled HLO: here nothing is
compiled and nothing is allocated (meta tensors have shapes only), and
``launch/op_cost.py`` counts each aten op and each hand-written kernel's
call (by the cost function beside it) as the card would run them.

Usage:
    PYTHONPATH=src python -m repro_torch.launch.dryrun --arch qwen3-4b --shape train_4k
    PYTHONPATH=src python -m repro_torch.launch.dryrun --all [--layout baseline]
    PYTHONPATH=src python -m repro_torch.launch.dryrun --cell xlstm-350m:prefill_32k

Results land in results/dryrun_h100/<arch>__<shape>__1xH100__<layout>.json
and feed ``launch/roofline.py``.

A meta tensor has no values, so a step that read one back to the host
(``.item()``, ``.cpu()``, ``int(tensor)``) could not be traced. None of
the three steps does, for any arch: positions and MoE capacities are
Python ints of the shapes and config (``models/moe.py::_capacity``,
``decode_step``'s ``pos``), the kernels' wrappers read nothing of their
inputs on the host, and what the host reads back (the engine's next
tokens, a loss for the log) is outside the step. What the card's route
asks of the device instead (the sLSTM's units a block, from the SM count
and occupancy) is an H100's rule on meta (``kernels/slstm/kernel.py::
h100_units``), held equal on the card by ``chip_smoke.py``.

Layouts keep the reference's names; the port reads only ``READ_FIELDS``
of a layout on one device, so a preset that differs from another only in
mesh knobs gives the same numbers, and its record says which
(``same_numbers_as``).
"""
from __future__ import annotations

import argparse
import json
import pathlib
import time
import traceback
from typing import Any, Dict, Optional

import torch

from repro_torch.config import (
    InputShape,
    ModelConfig,
    ShardingLayout,
    TrainConfig,
    get_arch,
    get_shape,
    runnable_cells,
)
from repro_torch.launch.op_cost import OpCost, tensors
from repro_torch.models import common, zoo
from repro_torch.optim import OptState
from repro_torch.train.steps import (
    TrainState,
    build_decode_step,
    build_prefill_step,
    build_train_step,
)

RESULTS_DIR = pathlib.Path(__file__).resolve().parents[3] / "results" / "dryrun_h100"
MESH = "1xH100"

# the reference's presets, by the same names (launch/dryrun.py)
LAYOUTS: Dict[str, ShardingLayout] = {
    "baseline": ShardingLayout(),
    "triangular": ShardingLayout(name="triangular", attn_impl="triangular"),
    "seqpar": ShardingLayout(
        name="seqpar", sequence_shard_activations=True, attn_impl="triangular"
    ),
    "tp_only": ShardingLayout(name="tp_only", param_rules="tp_only"),
    "bf16_grads": ShardingLayout(
        name="bf16_grads", gradient_allreduce_dtype="bfloat16", attn_impl="triangular"
    ),
    "remat_dots": ShardingLayout(name="remat_dots", remat="dots", attn_impl="triangular"),
    "fsdp_heavy": ShardingLayout(name="fsdp_heavy", param_rules="fsdp_heavy"),
    "int8_cache": ShardingLayout(name="int8_cache", int8_kv_cache=True),
    "decode_unroll": ShardingLayout(name="decode_unroll", decode_unroll=True),
    "naive": ShardingLayout(
        name="naive", sequence_shard_activations=False, fused_ce=False
    ),
    "attn_gather": ShardingLayout(name="attn_gather", attn_gather_kv=True),
    "tri_gather": ShardingLayout(
        name="tri_gather", attn_impl="triangular", attn_gather_kv=True
    ),
    "tri_gather_bf16g": ShardingLayout(
        name="tri_gather_bf16g", attn_impl="triangular", attn_gather_kv=True,
        gradient_allreduce_dtype="bfloat16",
    ),
    "bigchunk": ShardingLayout(
        name="bigchunk", attn_impl="triangular", q_chunk=2048, kv_chunk=4096
    ),
    "tri_gather_bigchunk": ShardingLayout(
        name="tri_gather_bigchunk", attn_impl="triangular", attn_gather_kv=True,
        q_chunk=2048, kv_chunk=4096,
    ),
    "tri_bigchunk": ShardingLayout(
        name="tri_bigchunk", attn_impl="triangular", q_chunk=2048, kv_chunk=4096
    ),
    "tri_bigchunk_dots": ShardingLayout(
        name="tri_bigchunk_dots", attn_impl="triangular",
        q_chunk=2048, kv_chunk=4096, remat="dots",
    ),
    "moe_tp": ShardingLayout(name="moe_tp", param_rules="moe_tp"),
    "tri_zero1": ShardingLayout(
        name="tri_zero1", attn_impl="triangular",
        param_rules="tp_only", opt_rules="baseline",
    ),
    "tri_zero1_bigchunk": ShardingLayout(
        name="tri_zero1_bigchunk", attn_impl="triangular",
        param_rules="tp_only", opt_rules="baseline",
        q_chunk=2048, kv_chunk=4096,
    ),
}

# the reference's gradient accumulation for train_4k and its per-cell
# layout overrides (launch/dryrun.py), copied
TRAIN_MICROBATCHES: Dict[str, int] = {
    "qwen1.5-32b": 2,
    "mixtral-8x7b": 2,
    "phi3.5-moe-42b-a6.6b": 4,
    "internvl2-26b": 4,
    "gemma-7b": 2,
}
CELL_LAYOUT_OVERRIDES: Dict[tuple, str] = {
    ("qwen1.5-32b", "decode_32k"): "int8_cache",
}

# the layout fields the port reads on one device (``train/steps.py``,
# ``models/transformer.py``); the rest are mesh and scan knobs
READ_FIELDS = ("attn_impl", "q_chunk", "kv_chunk", "remat", "int8_kv_cache", "fused_ce",
               "ce_chunk", "gradient_allreduce_dtype")


def read_fields(layout: ShardingLayout) -> Dict[str, Any]:
    return {f: getattr(layout, f) for f in READ_FIELDS}


def same_numbers_as(layout: ShardingLayout) -> str:
    """The first preset (in ``LAYOUTS``' order) whose read fields equal this
    layout's: its numbers are this one's."""
    want = read_fields(layout)
    return next((name for name, other in LAYOUTS.items() if read_fields(other) == want),
                layout.name)


def meta_tree(specs: Any) -> Any:
    """Meta tensors of the specs' shapes and dtypes: nothing allocated."""
    return common.tree_map(
        lambda s: torch.empty(s.shape, dtype=common.torch_dtype(s.dtype), device="meta"), specs)


def meta_inputs(cfg: ModelConfig, batch: int, seq_len: int, mode: str) -> Dict[str, torch.Tensor]:
    return {name: torch.empty(shape, dtype=dtype, device="meta")
            for name, (shape, dtype) in zoo.input_specs(cfg, batch, seq_len, mode).items()}


def trace_step(cfg: ModelConfig, shape: InputShape, layout: ShardingLayout,
               microbatches: int = 1) -> Dict[str, Any]:
    """One step of ``shape.mode`` at the shape's global batch and sequence,
    traced on meta tensors under ``OpCost``: its counts, and for decode the
    dense cache's bytes."""
    model = zoo.build_model(cfg)
    params = meta_tree(model.specs)
    out: Dict[str, Any] = {}
    cost = OpCost()
    B, S = shape.global_batch, shape.seq_len
    if shape.mode == "train":
        tc = TrainConfig(microbatches=microbatches)
        state = TrainState(params=params, opt=OptState(
            m=meta_tree(model.specs), v=meta_tree(model.specs), count=0), step=0)
        batch = meta_inputs(cfg, B, S, "train")
        step = build_train_step(model, tc, layout)
        cost.track(tensors((state.params, state.opt.m, state.opt.v, batch)))
        with cost:
            step(state, batch)
    elif shape.mode == "prefill":
        batch = meta_inputs(cfg, B, S, "prefill")
        step = build_prefill_step(model, layout, S)
        cost.track(tensors((params, batch)))
        with torch.no_grad(), cost:
            step(params, batch)
    else:
        cache = meta_tree(model.cache_specs(B, S, int8=layout.int8_kv_cache))
        tokens = meta_inputs(cfg, B, S, "decode")["tokens"]
        step = build_decode_step(model, layout)
        out["cache_bytes_per_device"] = sum(t.numel() * t.element_size()
                                            for t in tensors(cache))
        cost.track(tensors((params, cache, tokens)))
        with torch.no_grad(), cost:
            step(params, cache, tokens, S - 1)
    out.update(cost.record())
    return out


def run_cell(arch: str, shape_name: str, *, layout_name: str = "baseline",
             save: bool = True, results_dir: Optional[pathlib.Path] = None) -> Dict[str, Any]:
    if layout_name == "baseline":
        layout_name = CELL_LAYOUT_OVERRIDES.get((arch, shape_name), layout_name)
    layout = LAYOUTS[layout_name]
    shape = get_shape(shape_name)
    cfg = get_arch(arch)
    mb = TRAIN_MICROBATCHES.get(arch, 1) if shape.mode == "train" else 1
    t0 = time.time()
    counts = trace_step(cfg, shape, layout, mb)
    record = {
        "arch": arch,
        "shape": shape_name,
        "mode": shape.mode,
        "mesh": MESH,
        "layout": layout.name,
        "layout_reads": read_fields(layout),
        "same_numbers_as": same_numbers_as(layout),
        "params": cfg.param_count(),
        "microbatches": mb,
        **counts,
        "trace_seconds": round(time.time() - t0, 1),
    }
    if save:
        out = results_dir or RESULTS_DIR
        out.mkdir(parents=True, exist_ok=True)
        fname = f"{arch.replace('/', '_')}__{shape_name}__{MESH}__{layout.name}.json"
        (out / fname).write_text(json.dumps(record, indent=2))
    return record


def main(argv=None) -> None:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--arch")
    ap.add_argument("--shape")
    ap.add_argument("--cell", help="arch:shape")
    ap.add_argument("--all", action="store_true")
    ap.add_argument("--layout", default="baseline", choices=sorted(LAYOUTS))
    args = ap.parse_args(argv)
    if args.cell:
        args.arch, args.shape = args.cell.split(":")
    if not args.all and not (args.arch and args.shape):
        ap.error("give --all, --cell arch:shape, or --arch and --shape")
    cells = runnable_cells() if args.all else [(args.arch, args.shape)]
    failures = []
    for arch, shape in cells:
        tag = f"{arch}:{shape} mesh={MESH} layout={args.layout}"
        try:
            r = run_cell(arch, shape, layout_name=args.layout)
            print(f"OK {tag} flops={r['flops']:.3e} hbm={r['hbm_bytes']:.3e} "
                  f"peak_gib={r['peak_bytes_per_device'] / 2**30:.2f} "
                  f"kernels={r['kernel_calls']} trace_s={r['trace_seconds']}", flush=True)
        except Exception as e:  # noqa: BLE001 — report and go on with the sweep
            failures.append((tag, repr(e)))
            print(f"FAIL {tag}: {e!r}", flush=True)
            traceback.print_exc()
    if failures:
        for t, e in failures:
            print(f"failed cell {t}: {e}")
        raise SystemExit(1)
    print(f"all cells traced: {len(cells)}")


if __name__ == "__main__":
    main()
