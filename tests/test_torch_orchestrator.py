"""The port's ``SpotTrainingOrchestrator`` against the reference's, on the
CPU.

Reduced qwen3-4b in f32, both starting from the reference's
``init_train_state(model, jax.random.key(0))`` (carried across by
``train_state_from_jax``), on the config of ``tests/test_orchestrator.py``
(seq 32, batch 4, 30 steps in segments of 10, ``ckpt_every=5``) in the three
modes, and on the split scenario of ``benchmarks/orchestrator_bench.py``
(a 400 GB job on two 8-device legs, leg B revoked mid-segment at future
hour 2), the reference in an 8-device subprocess and the port on a pool of
8 CPU slots. Deterministic report columns, event lists and bills must be
equal; losses match at rtol 1e-4 and params at atol 1e-5 (XLA and torch
sum in different orders); the port's JSONL trace replays bit-exactly
through the reference's ``repro.obs.replay``.
"""
import contextlib
import dataclasses
import json
import os
from pathlib import Path
import subprocess
import sys
import tempfile
import textwrap

import jax
import numpy as np
import pytest

from repro.config import TrainConfig as RefTrainConfig
from repro.config import get_arch as ref_get_arch
from repro.core import generate_markets as ref_generate_markets
from repro.core import orchestrator as ref_orch
from repro.core import split_history_future as ref_split
from repro.data import SyntheticLM as RefSyntheticLM
from repro.launch.mesh import make_host_mesh
from repro.models import build_model as ref_build_model
from repro.obs import events as ref_ev
from repro.obs.export import read_jsonl as ref_read_jsonl
from repro.obs.recorder import recording as ref_recording
from repro.obs.replay import verify_events
from repro.train.steps import init_train_state as ref_init_train_state
from repro_torch.config import ShardingLayout, TrainConfig, get_arch
from repro_torch.core import generate_markets, split_history_future
from repro_torch.core import orchestrator as orch
from repro_torch.core.market import Market, MarketSet
from repro_torch.data import SyntheticLM
from repro_torch.dist import ElasticMeshManager, train_state_bytes
from repro_torch.models import build_model
from repro_torch.models.convert import params_to_numpy, train_state_from_jax
from repro_torch.obs import events as ev
from repro_torch.obs import read_jsonl, recording, write_jsonl

REPO = Path(__file__).resolve().parents[1]
LOSS_RTOL = 1e-4
PARAM_ATOL = 1e-5
COLUMNS = ("total_steps", "useful_steps", "wasted_steps", "revocations", "markets_used",
           "allocations_used", "leg_repairs", "leg_costs", "cost_dollars", "reshard_bytes",
           "restore_bytes", "reshard_events", "mesh_shapes", "cost_to_complete")
MODES = {"siwoft": {}, "checkpoint": {"ft_revocations": 2}, "hybrid": {}}


def _cfgs():
    return (dataclasses.replace(ref_get_arch("qwen3-4b").reduced(), dtype="float32"),
            dataclasses.replace(get_arch("qwen3-4b").reduced(), dtype="float32"))


@contextlib.contextmanager
def _segments(module, to_numpy):
    """Wrap ``module.run_segment``: record each call's start step and input
    params (copied: the port's step updates them in place) and each
    finished segment's state, so the last one is the run's final state."""
    calls, last = [], {}
    inner = module.run_segment

    def wrapped(model, state, *args, start_step=0, **kw):
        calls.append((start_step, to_numpy(state.params)))
        res = inner(model, state, *args, start_step=start_step, **kw)
        last["params"] = to_numpy(res.state.params)
        return res

    module.run_segment = wrapped
    try:
        yield calls, last
    finally:
        module.run_segment = inner


def _ref_np(tree):
    return jax.tree_util.tree_map(lambda a: np.array(a, np.float32), tree)


def _report_dict(rep):
    return {k: getattr(rep, k) for k in COLUMNS}


def _assert_trees_close(a, b):
    fa, fb = jax.tree_util.tree_leaves(a), jax.tree_util.tree_leaves(b)
    assert len(fa) == len(fb)
    for x, y in zip(fa, fb):
        np.testing.assert_allclose(x, y, atol=PARAM_ATOL, rtol=0)


@pytest.fixture(scope="module")
def modes():
    """Both orchestrators in each mode, on the test_orchestrator config."""
    ref_cfg, cfg = _cfgs()
    ref_model, model = ref_build_model(ref_cfg), build_model(cfg)
    init = _ref_np(ref_init_train_state(ref_model, jax.random.key(0)))
    ref_ms = ref_split(ref_generate_markets(seed=3, n_hours=24 * 120), 24 * 90)
    ms = split_history_future(generate_markets(seed=3, n_hours=24 * 120), 24 * 90)
    out = {}
    for mode, kw in MODES.items():
        with tempfile.TemporaryDirectory() as d, ref_recording() as rec, \
                _segments(ref_orch, _ref_np) as (_, ref_last):
            ref_rep = ref_orch.SpotTrainingOrchestrator(
                ref_model, RefSyntheticLM(ref_cfg.vocab_size, 32, 4, seed=0),
                make_host_mesh(), *ref_ms, mode=mode,
                tc=RefTrainConfig(total_steps=60, warmup_steps=5), segment_steps=10,
                steps_per_trace_hour=200, ckpt_dir=d, ckpt_every=5, seed=0, **kw,
            ).run(30)
            ref_events = list(rec.events)
        with tempfile.TemporaryDirectory() as d, recording() as prec, \
                _segments(orch, params_to_numpy) as (_, last):
            o = orch.SpotTrainingOrchestrator(
                model, SyntheticLM(cfg.vocab_size, 32, 4, seed=0), "cpu", *ms, mode=mode,
                tc=TrainConfig(total_steps=60, warmup_steps=5), layout=ShardingLayout(),
                segment_steps=10, steps_per_trace_hour=200, ckpt_dir=d, ckpt_every=5,
                seed=0, init_state=lambda: train_state_from_jax(init, cfg, "cpu"), **kw,
            )
            rep = o.run(30)
            if o.ckpt is not None:
                o.ckpt.close()
            events = list(prec.events)
        out[mode] = (ref_rep, ref_events, ref_last["params"], rep, events, last["params"])
    return out


@pytest.mark.parametrize("mode", sorted(MODES))
def test_mode_matches_reference(modes, mode):
    ref_rep, ref_events, ref_params, rep, events, params = modes[mode]
    assert _report_dict(rep) == _report_dict(ref_rep)
    assert dataclasses.asdict(rep.breakdown) == dataclasses.asdict(ref_rep.breakdown)
    assert [ev.as_dict(e) for e in events] == [ref_ev.as_dict(e) for e in ref_events]
    np.testing.assert_allclose(rep.losses, ref_rep.losses, rtol=LOSS_RTOL, atol=0)
    _assert_trees_close(params, ref_params)
    assert rep.useful_steps == 30 and rep.losses[0] > rep.losses[-1]
    if mode == "checkpoint":
        assert rep.revocations >= 1 and rep.restore_bytes > 0 and not rep.snapshots


@pytest.mark.parametrize("mode", sorted(MODES))
def test_trace_replays_through_reference(modes, mode, tmp_path):
    *_, events, _ = modes[mode]
    path = tmp_path / f"{mode}.jsonl"
    assert write_jsonl(path, events) == len(events)
    assert [ev.as_dict(e) for e in read_jsonl(path)] == [ev.as_dict(e) for e in events]
    runs, problems = verify_events(ref_read_jsonl(path))
    assert problems == [] and len(runs) == 1 and runs[0].pin is not None


SPLIT_MARKETS = [
    ("big8.a", "us-east-1", "us-east-1a", 40, 1.2, 8, 60.0),
    ("big8.b", "eu-west-1", "eu-west-1a", 40, 1.2, 8, 60.0),
    ("big8.c", "ap-southeast-1", "ap-southeast-1a", 40, 1.2, 8, 60.0),
    ("small1", "us-east-1", "us-east-1b", 64, 0.4, 1, 10.0),
]


def split_market_sets(market_cls, set_cls):
    """The bench's split scenario: A and B calm in history, C mildly
    revoking, a 1-device market that never fits; B revokes at future hour 2."""
    markets = [market_cls(i, *m[:5], device_count=m[5], interconnect_gbps=m[6])
               for i, m in enumerate(SPLIT_MARKETS)]
    hp = np.full((4, 90), 0.35)
    hp[2, ::45] = 1.5
    hp[3, ::5] = 0.6
    fp = np.full((4, 24), 0.35)
    fp[1, 2:4] = 1.5
    return set_cls(markets, hp), set_cls(markets, fp, start_hour=90)


SPLIT_REFERENCE = textwrap.dedent(
    """
    import os
    os.environ["XLA_FLAGS"] = "--xla_force_host_platform_device_count=8"
    import dataclasses, json, sys
    import jax, numpy as np
    sys.path.insert(0, os.environ["TESTS_DIR"])
    from test_torch_orchestrator import COLUMNS, split_market_sets, _ref_np
    from repro.config import TrainConfig, get_arch
    from repro.core import orchestrator as orch
    from repro.core.market import Market, MarketSet
    from repro.data import SyntheticLM
    from repro.launch.mesh import make_host_mesh
    from repro.models import build_model
    from repro.obs import events as ev
    from repro.obs.recorder import recording

    cfg = dataclasses.replace(get_arch("qwen3-4b").reduced(), dtype="float32")
    model = build_model(cfg)
    starts = []
    inner = orch.run_segment
    def wrapped(model, state, *a, start_step=0, **kw):
        starts.append((start_step, _ref_np(state.params)))
        return inner(model, state, *a, start_step=start_step, **kw)
    orch.run_segment = wrapped
    with recording() as rec:
        rep = orch.SpotTrainingOrchestrator(
            model, SyntheticLM(cfg.vocab_size, 32, 4, seed=0), make_host_mesh(),
            *split_market_sets(Market, MarketSet), mode="siwoft",
            tc=TrainConfig(total_steps=80, warmup_steps=2), segment_steps=10,
            steps_per_trace_hour=1, seed=0, job_memory_gb=400.0,
        ).run(40)
    seen, handoff = set(), None
    for s, p in starts:
        if s in seen:
            handoff = (s, p)
            break
        seen.add(s)
    leaves = jax.tree_util.tree_leaves(handoff[1])
    np.savez(os.environ["HANDOFF_NPZ"], *leaves)
    print("SPLIT_JSON " + json.dumps({
        "n_devices": len(jax.devices()), "handoff_step": handoff[0],
        "report": {k: getattr(rep, k) for k in COLUMNS},
        "leg_costs": {str(k): v for k, v in rep.leg_costs.items()},
        "breakdown": dataclasses.asdict(rep.breakdown),
        "losses": rep.losses, "events": [ev.as_dict(e) for e in rec.events],
    }))
    """
)


def _jsonable(x):
    return json.loads(json.dumps(x))


@pytest.fixture(scope="module")
def split(tmp_path_factory):
    npz = tmp_path_factory.mktemp("split") / "handoff.npz"
    env = {**os.environ, "PYTHONPATH": str(REPO / "src"), "TESTS_DIR": str(REPO / "tests"),
           "HANDOFF_NPZ": str(npz)}
    res = subprocess.run([sys.executable, "-c", SPLIT_REFERENCE], capture_output=True,
                         text=True, timeout=300, env=env, cwd=str(REPO))
    ref = next((json.loads(line[len("SPLIT_JSON "):]) for line in res.stdout.splitlines()
                if line.startswith("SPLIT_JSON ")), None)
    assert ref is not None, f"reference subprocess failed:\n{res.stdout}\n{res.stderr}"
    assert ref["n_devices"] == 8
    with np.load(npz) as z:
        ref_handoff = [z[f"arr_{i}"] for i in range(len(z.files))]

    ref_cfg, cfg = _cfgs()
    init = _ref_np(ref_init_train_state(ref_build_model(ref_cfg), jax.random.key(0)))
    model = build_model(cfg)
    with recording() as rec, _segments(orch, params_to_numpy) as (calls, _):
        rep = orch.SpotTrainingOrchestrator(
            model, SyntheticLM(cfg.vocab_size, 32, 4, seed=0), "cpu",
            *split_market_sets(Market, MarketSet), mode="siwoft",
            tc=TrainConfig(total_steps=80, warmup_steps=2), layout=ShardingLayout(),
            segment_steps=10, steps_per_trace_hour=1, seed=0, job_memory_gb=400.0,
            mesh_manager=ElasticMeshManager(["cpu"] * 8),
            init_state=lambda: train_state_from_jax(init, cfg, "cpu"),
        ).run(40)
    starts = [s for s, _ in calls]
    handoff = next((i for i, s in enumerate(starts) if s in starts[:i]), None)
    return ref, ref_handoff, rep, list(rec.events), model, calls, handoff


def test_split_scenario_matches_reference(split):
    ref, _, rep, events, model, *_ = split
    got = _jsonable({k: getattr(rep, k) for k in COLUMNS})
    assert got == ref["report"]
    assert {str(k): v for k, v in rep.leg_costs.items()} == ref["leg_costs"]
    assert _jsonable(dataclasses.asdict(rep.breakdown)) == ref["breakdown"]
    assert _jsonable([ev.as_dict(e) for e in events]) == ref["events"]
    np.testing.assert_allclose(rep.losses, ref["losses"], rtol=LOSS_RTOL, atol=0)
    # the bench's asserts: a 2-leg allocation loses leg B, repairs only that
    # leg (fewer bytes than a full restore) and finishes; legs sum to the bill
    assert len(rep.allocations_used[0]) == 2 and rep.useful_steps == 40
    assert rep.revocations >= 1 and rep.leg_repairs >= 1
    assert 0 < rep.reshard_bytes < train_state_bytes(model)
    assert abs(sum(rep.leg_costs.values()) - rep.cost_dollars) < 1e-6


def test_mid_segment_handoff_restores_segment_start(split):
    """B's revocation cuts a segment after some of its steps ran; siwoft
    hands the segment's START state to the repaired allocation. The port's
    step updated those tensors in place, so only the host snapshot taken
    before the segment gives them back: the handed-off params must equal
    the reference's (immutable) segment-start params."""
    ref, ref_handoff, rep, _, _, calls, handoff = split
    assert handoff is not None and calls[handoff][0] == ref["handoff_step"]
    step, params = calls[handoff]
    _assert_trees_close(jax.tree_util.tree_leaves(params), ref_handoff)
    assert rep.wasted_steps > 0                       # the cut segment ran steps
    assert [s["step"] for s in rep.snapshots] == [step]
    assert rep.snapshots[0]["bytes"] > 0 and rep.snapshots[0]["restore_seconds"] is not None
