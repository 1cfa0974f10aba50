"""The port's dry run for one H100 (``launch/{op_cost,dryrun,roofline}.py``)
on the CPU, where every cell is traced on the meta device.

* ``OpCost`` against the reference's HLO walker (``hlo_cost.analyze_hlo``)
  on the programs of ``tests/test_hlo_cost.py``, at that file's
  tolerances: one product, 7 products in a loop, 3 x 5 in nested loops.
* A reduced qwen3-4b (d_model 512, so that products dominate) training step
  and prefill under ``attn_impl="masked"``: the port's FLOPs on meta within
  10% of the reference's walker over the same step lowered on one CPU
  device (``build_train_step(..., constrain=None)``). The gap found: +1.1%
  (train), -0.2% (prefill); eager PyTorch counts a few elementwise ops XLA
  fuses away or folds.
* The peak estimator on a scripted sequence of allocations, views and
  frees: exactly the live bytes at each point.
* ``param_count``, ``active_param_count`` and ``sub_quadratic`` of every
  arch, the shapes and ``runnable_cells()`` equal to the reference's, and
  ``roofline.model_flops`` for every runnable cell.
* Each kernel's cost function (its ``ops.py``) gives PERF.md §6's bound
  column at that table's shapes, to the table's 4 decimals.
* Each kernel's ``ops.py`` route on the meta device returns the shapes
  and dtypes its CPU route returns (gradients too), and reports its
  kernels' calls to ``OpCost`` under their launch counters' names.
* The dry run's CLI end to end over xlstm-350m's four runnable cells and
  whisper-tiny's train_4k and decode_32k (its prefill_32k, 54 s of
  tracing here, is left to ``--all``), then the roofline over the records.
"""
import contextlib
import dataclasses
import json

import jax
import jax.numpy as jnp
import pytest
import torch

from repro.config import InputShape as JaxShape
from repro.config import ShardingLayout as JaxLayout
from repro.config import TrainConfig as JaxTrainConfig
from repro.config import get_arch as jax_get_arch
from repro.config import get_shape as jax_get_shape
from repro.config import list_shapes as jax_list_shapes
from repro.config import runnable_cells as jax_cells
from repro.launch import hlo_cost
from repro.launch import roofline as jax_roofline
from repro.models import build_model as jax_build_model
from repro.models import input_specs as jax_input_specs
from repro.models.common import abstract_params
from repro.train.steps import abstract_train_state
from repro.train.steps import build_prefill_step as jax_prefill_step
from repro.train.steps import build_train_step as jax_train_step
from repro_torch.config import (
    InputShape,
    ShardingLayout,
    get_arch,
    get_shape,
    list_archs,
    list_shapes,
    runnable_cells,
)
from repro_torch.kernels.flash_attention import ops as flash_ops
from repro_torch.kernels.mlstm import ops as mlstm_ops
from repro_torch.kernels.paged_attention import ops as paged_ops
from repro_torch.kernels.slstm import ops as slstm_ops
from repro_torch.kernels.ssm_scan import ops as scan_ops
from repro_torch.launch import dryrun, roofline
from repro_torch.launch.op_cost import OpCost

META = torch.device("meta")


def _jax_flops(f, *args):
    return hlo_cost.analyze_hlo(jax.jit(f).lower(*args).compile().as_text())["flops"]


def _meta_flops(f, *shapes):
    with OpCost() as cost:
        f(*(torch.empty(s, device=META) for s in shapes))
    return cost.record()["flops"]


def _loop(n):
    def f(a, w):
        for _ in range(n):
            a = a @ w
        return a
    return f


def _jax_scan(n, inner=None):
    def f(a, w):
        body = (lambda c, _: (c @ w, None)) if inner is None else \
            (lambda c, _: (jax.lax.scan(lambda cc, _: (cc @ w, None), c, None, length=inner)[0],
                           None))
        return jax.lax.scan(body, a, None, length=n)[0]
    return f


@pytest.mark.parametrize("name,n,inner,size,rel", [
    ("one product", 1, None, 256, 0.01),
    ("7 products in a loop", 7, None, 256, 0.02),
    ("nested loops", 5, 3, 128, 0.05),
])
def test_op_cost_matches_the_hlo_walker(name, n, inner, size, rel):
    x = jax.ShapeDtypeStruct((size, size), jnp.float32)
    ref = _jax_flops(_jax_scan(n, inner) if n > 1 else (lambda a, b: a @ b), x, x)
    ours = _meta_flops(_loop(n * (inner or 1)), (size, size), (size, size))
    assert ref == pytest.approx(n * (inner or 1) * 2 * size**3, rel=rel)
    assert ours == pytest.approx(ref, rel=rel)


def _qwen(mode):
    kw = dict(d_model=512, num_layers=2, vocab_size=1024, num_heads=8, num_kv_heads=4,
              head_dim=64, d_ff=2048, dtype="float32")
    return (dataclasses.replace(jax_get_arch("qwen3-4b").reduced(), **kw),
            dataclasses.replace(get_arch("qwen3-4b").reduced(), **kw))


@pytest.mark.parametrize("mode", ["train", "prefill"])
def test_reduced_qwen_step_flops_within_10pct_of_the_reference(mode):
    B, S = 2, 128
    jcfg, cfg = _qwen(mode)
    model = jax_build_model(jcfg)
    ins = jax_input_specs(jcfg, JaxShape("x", S, B, mode))
    if mode == "train":
        step = jax_train_step(model, JaxTrainConfig(), JaxLayout(), constrain=None)
        ref = _jax_flops(step, abstract_train_state(model), ins)
    else:
        step = jax_prefill_step(model, JaxLayout(), S, constrain=None)
        ref = _jax_flops(step, abstract_params(model.specs), ins)
    ours = dryrun.trace_step(cfg, InputShape("x", S, B, mode), ShardingLayout())
    assert ours["flops"] == pytest.approx(ref, rel=0.10)
    assert ours["kernel_calls"] == {} and ours["collective_wire_bytes"] == 0


def test_peak_estimator_on_scripted_allocations():
    cost = OpCost()
    kept = torch.empty(256, device=META)                 # 1024 B, there before
    cost.track([kept, kept.view(16, 16)])
    assert (cost.live, cost.peak) == (1024, 1024)
    with cost:
        a = torch.empty(1000, device=META)                # + 4000
        b = torch.zeros(500, dtype=torch.bfloat16, device=META)   # + 1000
        v = a.view(10, 100)[2:]                            # a view: nothing
        assert (cost.live, cost.peak) == (6024, 6024)
        del a                                              # the view keeps the storage
        assert cost.live == 6024
        del v
        assert cost.live == 2024
        c = b.float()                                      # + 2000
        assert (cost.live, cost.peak) == (4024, 6024)
        d = torch.empty(2000, device=META)                 # + 8000
        assert (cost.live, cost.peak) == (12024, 12024)
        del b, c, d
    assert (cost.live, cost.peak) == (1024, 12024)
    del kept
    assert cost.live == 0


def test_param_counts_and_cells_equal_the_reference():
    for arch in list_archs():
        cfg, jcfg = get_arch(arch), jax_get_arch(arch)
        assert cfg.param_count() == jcfg.param_count()
        assert cfg.active_param_count() == jcfg.active_param_count()
        assert cfg.sub_quadratic == jcfg.sub_quadratic
    assert runnable_cells() == jax_cells()
    assert {n: dataclasses.asdict(get_shape(n)) for n in list_shapes()} == {
        n: dataclasses.asdict(jax_get_shape(n)) for n in jax_list_shapes()}


def test_model_flops_equal_the_reference():
    for arch, shape in runnable_cells():
        assert roofline.model_flops(arch, shape) == jax_roofline.model_flops(arch, shape)


def _ms(cost, rate):
    flops, nbytes = cost
    return max(flops / roofline.PEAKS.get(rate, roofline.F32_FMA_FLOPS),
               nbytes / roofline.HBM_BANDWIDTH) * 1e3


FLASH_S2000 = dict(B=1, Sq=2000, Skv=2000, H=32, KVH=8, hd=128)
FLASH_S4096 = dict(FLASH_S2000, Sq=4096, Skv=4096)
FLASH_F32 = dict(FLASH_S2000, Sq=1000, Skv=1000, el=4)
MLSTM = dict(B=8, S=4096, H=4, hd=512)
# (PERF.md §6 row, cost, rate, the bound column's ms)
BOUNDS = [
    ("1", flash_ops.fwd_cost(**FLASH_S2000), "bf16", 0.0331),
    ("1 hymba", flash_ops.fwd_cost(B=8, Sq=4096, Skv=4096, H=25, KVH=5, hd=64, window=1024),
     "bf16", 0.1900),
    ("1 S4096", flash_ops.fwd_cost(**FLASH_S4096), "bf16", 0.1390),
    ("1 S8192 w4096", flash_ops.fwd_cost(**dict(FLASH_S4096, Sq=8192, Skv=8192), window=4096),
     "bf16", 0.4169),
    ("1f", flash_ops.fwd_cost(**FLASH_F32), "tf32x3", 0.0497),
    ("2", paged_ops.cost(B=8, H=32, KVH=8, hd=128, tokens=9790, pages=616), "bf16", 0.0120),
    # the int8 pool at qwen1.5-32b's decode (8 lanes, 7804 cached tokens in 491 pages)
    ("2i", paged_ops.int8_cost(B=8, H=40, KVH=40, hd=128, tokens=7804, pages=491), "bf16",
     0.0243),
    ("2if", paged_ops.int8_cost(B=8, H=40, KVH=40, hd=128, tokens=7804, pages=491, el=4), "f32",
     0.0247),
    ("3a", flash_ops.dkdv_cost(**FLASH_S4096), "bf16", 0.2780),
    ("3af", flash_ops.dkdv_cost(**FLASH_F32), "tf32x3", 0.0994),
    ("3b", flash_ops.dq_cost(**FLASH_S4096), "bf16", 0.0695),
    ("3bf", flash_ops.dq_cost(**FLASH_F32), "tf32x3", 0.0248),
    ("4", scan_ops.cost(B=8, S=4096, inner=3200, N=16, el=2), "f32", 0.2527),
    ("4b", scan_ops.bwd_cost(B=1, S=4096, inner=3200, N=16, el=2), "f32", 0.0626),
    ("5t", mlstm_ops.cost(**MLSTM, el=2), "bf16", 0.1706),
    ("5f", mlstm_ops.cost(**MLSTM, el=4), "tf32x3", 0.8346),
    ("5s", mlstm_ops.cost(**dict(MLSTM, S=1), el=2, state=True), "f32", 0.0201),
    ("5b bf16", mlstm_ops.bwd_cost(**dict(MLSTM, B=1), el=2), "bf16", 0.0401),
    ("5b f32", mlstm_ops.bwd_cost(**dict(MLSTM, B=1), el=4), "tf32x3", 0.2091),
    ("6 B8", slstm_ops.cost(B=8, S=4096, d=1024), "f32", 4.1027),
    ("6 B1", slstm_ops.cost(B=1, S=4096, d=1024), "f32", 0.5128),
    ("6 decode", slstm_ops.cost(B=8, S=1, d=1024), "f32", 0.0051),
    ("6b", slstm_ops.bwd_cost(B=1, S=4096, d=1024), "f32", 1.0257),
]


@pytest.mark.parametrize("row,cost,rate,want", BOUNDS, ids=[b[0] for b in BOUNDS])
def test_cost_functions_give_the_bound_column(row, cost, rate, want):
    # the table gives ms to 4 decimals
    assert abs(_ms(cost, rate) - want) <= 5e-5


def _same_shapes(cpu, meta):
    cpu, meta = [t for t in cpu if t is not None], [t for t in meta if t is not None]
    assert [(tuple(t.shape), t.dtype) for t in cpu] == [(tuple(t.shape), t.dtype) for t in meta]
    assert all(t.device == META for t in meta)


def _both(make, fn, grads=True):
    """``fn`` on CPU tensors (the plain versions) and on meta copies (the
    kernels' route); with ``grads`` also the inputs' gradients of a sum of
    the outputs. Returns the kernel calls the meta run reported."""
    out = {}
    cost = OpCost()
    for dev in ("cpu", "meta"):
        ins = [t.to(dev).requires_grad_(grads and t.is_floating_point()) if t is not None
               else None for t in make()]
        with cost if dev == "meta" else contextlib.nullcontext():
            res = fn(*ins)
            res = [t for t in (res if isinstance(res, (tuple, list)) else (res,))
                   for t in (t if isinstance(t, tuple) else (t,))]
            if grads:
                sum(t.float().sum() for t in res if t.requires_grad).backward()
        out[dev] = res + ([t.grad for t in ins if t is not None and t.requires_grad]
                          if grads else [])
    _same_shapes(out["cpu"], out["meta"])
    return cost.kernel_calls


def test_meta_routes_allocate_what_the_cpu_routes_return():
    g = torch.Generator().manual_seed(0)
    rnd = lambda *s, dtype=torch.float32: torch.randn(s, generator=g).to(dtype)
    calls = _both(lambda: (rnd(1, 40, 4, 64, dtype=torch.bfloat16),
                           rnd(1, 40, 2, 64, dtype=torch.bfloat16),
                           rnd(1, 40, 2, 64, dtype=torch.bfloat16)),
                  lambda q, k, v: flash_ops.flash_attention(q, k, v, True, 16, 0))
    assert calls == {"flash_attention_tc": 1, "flash_attention_bwd_dkdv_tc": 1,
                     "flash_attention_bwd_dq_tc": 1}
    table = torch.tensor([[0, 1], [2, 3]], dtype=torch.int32)
    calls = _both(lambda: (rnd(2, 4, 64), rnd(4, 16, 2, 64), rnd(4, 16, 2, 64), table,
                           torch.tensor([20, 9], dtype=torch.int32)),
                  paged_ops.paged_decode_attention, grads=False)
    assert calls == {"paged_attention_fma": 1}
    calls = _both(lambda: (rnd(2, 24, 32), rnd(2, 24, 32).abs(), rnd(2, 24, 8), rnd(2, 24, 8),
                           -rnd(32, 8).abs(), rnd(32), rnd(2, 32, 8)), scan_ops.ssm_scan)
    assert calls == {"ssm_scan": 1, "ssm_scan_bwd": 1}
    calls = _both(lambda: (rnd(2, 20, 2, 32), rnd(2, 20, 2, 32), rnd(2, 20, 2, 32),
                           rnd(2, 20, 4)), lambda q, k, v, gt: mlstm_ops.mlstm(q, k, v, gt))
    assert calls == {"mlstm_tf32": 1, "mlstm_bwd": 1}
    calls = _both(lambda: (rnd(2, 3, 4, 32), rnd(2, 3, 4, 32), rnd(2, 3, 4, 32), rnd(2, 3, 8)),
                  lambda q, k, v, gt: mlstm_ops.mlstm(q, k, v, gt), grads=False)
    assert calls == {"mlstm_step": 1}
    calls = _both(lambda: (rnd(2, 7, 4 * 40), rnd(40, 4 * 40) * 0.1, rnd(2, 40),
                           rnd(2, 40).abs(), rnd(2, 40), rnd(2, 40)),
                  lambda wx, r, *st: slstm_ops.slstm(wx, r, tuple(st)))
    assert calls == {"slstm": 1, "slstm_bwd": 1}


def test_dryrun_cli_end_to_end(tmp_path, monkeypatch, capsys):
    monkeypatch.setattr(dryrun, "RESULTS_DIR", tmp_path)
    cells = [("xlstm-350m", s) for s in ("train_4k", "prefill_32k", "decode_32k", "long_500k")]
    cells += [("whisper-tiny", "train_4k"), ("whisper-tiny", "decode_32k")]
    assert set(cells) <= set(runnable_cells())
    for arch, shape in cells:
        dryrun.main(["--cell", f"{arch}:{shape}"])
    recs = {(r["arch"], r["shape"]): r for r in map(json.loads, (
        p.read_text() for p in sorted(tmp_path.glob("*.json"))))}
    assert set(recs) == set(cells)
    for (arch, shape), r in recs.items():
        assert r["mesh"] == "1xH100" and r["layout"] == "baseline" and r["flops"] > 0
        assert r["collective_wire_bytes"] == 0 and r["params"] == get_arch(arch).param_count()
        assert r["flops"] == pytest.approx(sum(r["flops_by_dtype"].values()))
        assert r["peak_bytes_per_device"] >= r.get("cache_bytes_per_device", 0)
    assert recs["xlstm-350m", "train_4k"]["kernel_calls"] == {
        "mlstm_tc": 40, "mlstm_bwd": 20, "slstm": 8, "slstm_bwd": 4}
    assert recs["xlstm-350m", "decode_32k"]["kernel_calls"] == {"mlstm_step": 20, "slstm": 4}
    assert recs["whisper-tiny", "train_4k"]["kernel_calls"] == {}      # masked attention
    assert dryrun.same_numbers_as(dryrun.LAYOUTS["tp_only"]) == "baseline"
    assert dryrun.same_numbers_as(dryrun.LAYOUTS["seqpar"]) == "triangular"
    rows = roofline.load(results_dir=tmp_path)
    assert len(rows) == len(cells)
    for r in rows:
        assert r["t_collective_s"] == 0 and r["t_roofline_s"] == max(r["t_compute_s"],
                                                                      r["t_memory_s"])
    table = roofline.markdown(rows)
    assert "NVIDIA H100 80GB HBM3, 700.00 W" in table and table.count("\n| ") == len(cells) + 1
