"""The port reproduces ``BENCH_orchestrator.json``'s deterministic columns
on the CPU: ``benchmarks/orchestrator_bench.py``'s three modes (market
seed 4, 60 steps in segments of 10, ``ckpt_every=5``, two injected
revocations for checkpoint) and its split scenario (on a pool of 8 CPU
slots), each column with the bench's own rounding.

``final_loss`` is the exception: the pinned 2.853049 (and the split's
3.3803) is not what the reference gives today (2.9151 at the bench's bf16;
2.9150 in f32), so the port's final loss is held at rtol 1e-4 to a fresh
reference run in f32 from the same initial weights instead. The split's
``cost_usd`` is pinned one ulp off the reference's today; it is held at
rel 1e-15.
"""
import dataclasses
import json
from pathlib import Path
import tempfile

import jax
import numpy as np
import pytest

from repro.config import TrainConfig as RefTrainConfig
from repro.config import get_arch as ref_get_arch
from repro.core import generate_markets as ref_generate_markets
from repro.core import split_history_future as ref_split
from repro.core.orchestrator import SpotTrainingOrchestrator as RefOrchestrator
from repro.data import SyntheticLM as RefSyntheticLM
from repro.launch.mesh import make_host_mesh
from repro.models import build_model as ref_build_model
from repro.train.steps import init_train_state as ref_init_train_state
from repro_torch.config import ShardingLayout, TrainConfig, get_arch
from repro_torch.core import generate_markets, split_history_future
from repro_torch.core.market import Market, MarketSet
from repro_torch.core.orchestrator import SpotTrainingOrchestrator
from repro_torch.data import SyntheticLM
from repro_torch.dist import ElasticMeshManager, train_state_bytes
from repro_torch.models import build_model
from repro_torch.models.convert import train_state_from_jax
from test_torch_orchestrator import split_market_sets

REPO = Path(__file__).resolve().parents[1]
BENCH = json.loads((REPO / "BENCH_orchestrator.json").read_text())
STEPS = 60


@pytest.fixture(scope="module")
def setup():
    ref_cfg = dataclasses.replace(ref_get_arch("qwen3-4b").reduced(), dtype="float32")
    cfg = dataclasses.replace(get_arch("qwen3-4b").reduced(), dtype="float32")
    ref_model = ref_build_model(ref_cfg)
    init = jax.tree_util.tree_map(np.asarray, ref_init_train_state(ref_model, jax.random.key(0)))
    ref = RefOrchestrator(
        ref_model, RefSyntheticLM(ref_cfg.vocab_size, 32, 4, seed=0), make_host_mesh(),
        *ref_split(ref_generate_markets(seed=4, n_hours=24 * 120), 24 * 90), mode="siwoft",
        tc=RefTrainConfig(total_steps=STEPS * 2, warmup_steps=5), segment_steps=10,
        steps_per_trace_hour=200, seed=0,
    ).run(STEPS)
    return cfg, build_model(cfg), lambda: train_state_from_jax(init, cfg, "cpu"), ref.losses[-1]


@pytest.mark.parametrize("mode", ["siwoft", "checkpoint", "hybrid"])
def test_bench_mode_columns(setup, mode):
    cfg, model, init, ref_final = setup
    ms = split_history_future(generate_markets(seed=4, n_hours=24 * 120), 24 * 90)
    with tempfile.TemporaryDirectory() as d:
        orch = SpotTrainingOrchestrator(
            model, SyntheticLM(cfg.vocab_size, 32, 4, seed=0), "cpu", *ms, mode=mode,
            tc=TrainConfig(total_steps=STEPS * 2, warmup_steps=5), layout=ShardingLayout(),
            segment_steps=10, steps_per_trace_hour=200, ckpt_dir=d, ckpt_every=5,
            ft_revocations=2, seed=0, init_state=init,
        )
        rep = orch.run(STEPS)
        if orch.ckpt is not None:
            orch.ckpt.close()
    want = BENCH["modes"][mode]
    got = {
        "useful_steps": rep.useful_steps,
        "wasted_steps": rep.wasted_steps,
        "revocations": rep.revocations,
        "goodput": round(rep.goodput, 4),
        "cost_usd": round(rep.cost_dollars, 6),
        "completion_trace_hours": round(rep.breakdown.total_time, 6),
        "reshard_bytes": rep.reshard_bytes,
        "restore_bytes": rep.restore_bytes,
        "reshard_usd": round(rep.breakdown.cost["reshard"], 8),
        "recovery_usd": round(rep.breakdown.cost["recovery"], 8),
        "cost_to_complete": round(rep.cost_to_complete, 6),
        "leg_costs": {str(k): round(v, 6) for k, v in sorted(rep.leg_costs.items())},
    }
    assert got == {k: want[k] for k in got}
    np.testing.assert_allclose(rep.losses[-1], ref_final, rtol=1e-4, atol=0)


def test_bench_split_scenario_columns(setup):
    cfg, model, init, _ = setup
    rep = SpotTrainingOrchestrator(
        model, SyntheticLM(cfg.vocab_size, 32, 4, seed=0), "cpu",
        *split_market_sets(Market, MarketSet), mode="siwoft",
        tc=TrainConfig(total_steps=80, warmup_steps=2), layout=ShardingLayout(),
        segment_steps=10, steps_per_trace_hour=1, seed=0, job_memory_gb=400.0,
        mesh_manager=ElasticMeshManager(["cpu"] * 8), init_state=init,
    ).run(40)
    want = BENCH["split_scenario"]
    got = {
        "steps": 40,
        "allocations_used": [list(a) for a in rep.allocations_used],
        "revocations": rep.revocations,
        "leg_repairs": rep.leg_repairs,
        "reshard_bytes": rep.reshard_bytes,
        "full_restore_bytes": train_state_bytes(model),
        "leg_costs": {str(k): v for k, v in sorted(rep.leg_costs.items())},
        "completion_trace_hours": rep.breakdown.total_time,
    }
    assert got == {k: want[k] for k in got}
    # the pinned total is one ulp below the reference's today (5.95), which
    # the port's equals bit for bit (tests/test_torch_orchestrator.py)
    assert rep.cost_dollars == pytest.approx(want["cost_usd"], rel=1e-15, abs=0)
