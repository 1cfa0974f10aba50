"""The port's placements and byte counters (``repro_torch.dist``) against
the reference's ``repro.dist`` on the CPU.

The reference's multi-device side runs in a subprocess with 8 forced host
devices (the test process is pinned to 1 CPU), as ``tests/test_meshplan.py``
does: it prints each placement's ``devices_indices_map`` and each byte
count for reduced qwen3-4b's train state (and full-width qwen3-4b's
abstract one), on plans of 1, 2, 4 and 8 devices and on the allocation
(4, 4), under ``ShardingLayout()`` and every registered rule table. The
port computes the same on a pool of 8 CPU slots; a device's id is its
slot. The ``ThroughputTracker`` cases are ``tests/test_throughput.py``'s.
"""
import json
import os
from pathlib import Path
import subprocess
import sys
import textwrap

import pytest
import torch

from repro.config import get_arch as ref_get_arch
from repro.dist import meshplan as ref_meshplan
from repro.models import build_model as ref_build_model
from repro_torch.config import ShardingLayout, get_arch
from repro_torch.core import shape_throughput
from repro_torch.dist import (
    ElasticMeshManager,
    Placement,
    ThroughputTracker,
    leg_state_bytes,
    mesh_shape_for,
    opt_state_shardings,
    param_shardings,
    replicated,
    reshard_bytes,
    reshard_tree,
    serve_state_bytes,
    train_state_bytes,
    tree_bytes,
)
from repro_torch.dist.meshplan import _norm_index
from repro_torch.models import build_model
from repro_torch.models.common import tree_flatten
from repro_torch.optim import OptState
from repro_torch.train.steps import TrainState, init_train_state

REPO = Path(__file__).resolve().parents[1]

# name -> ShardingLayout kwargs: the default layout, each rule table, and a
# ZeRO-1 layout whose moments follow other rules than the params
LAYOUTS = {
    "default": {},
    "baseline": {"param_rules": "baseline"},
    "tp_only": {"param_rules": "tp_only"},
    "fsdp_heavy": {"param_rules": "fsdp_heavy"},
    "moe_tp": {"param_rules": "moe_tp"},
    "zero1": {"param_rules": "tp_only", "opt_rules": "baseline"},
}

REFERENCE_SCRIPT = textwrap.dedent(
    """
    import os
    os.environ["XLA_FLAGS"] = "--xla_force_host_platform_device_count=8"
    import json
    import jax
    from repro.config import ShardingLayout, get_arch
    from repro.dist import (ElasticMeshManager, leg_state_bytes, opt_state_shardings,
                            param_shardings, reshard_bytes, tree_bytes)
    from repro.dist.meshplan import _norm_index
    from repro.models import build_model
    from repro.optim import OptState
    from repro.train.steps import TrainState, abstract_train_state, init_train_state

    LAYOUTS = json.loads(os.environ["DIST_LAYOUTS"])
    out = {"n_devices": len(jax.devices()), "maps": {}, "bytes": {}}
    man = ElasticMeshManager()
    plans = {"1": man.plan_for(1), "2": man.plan_for(2), "4": man.plan_for(4),
             "8": man.plan_for(8), "4+4": man.plan_for_allocation([4, 4])}
    reduced = build_model(get_arch("qwen3-4b").reduced())
    full = build_model(get_arch("qwen3-4b"))
    states = {"reduced": init_train_state(reduced, jax.random.key(0)),
              "full": abstract_train_state(full)}
    models = {"reduced": reduced, "full": full}

    def maps(tree):
        return [[[d.id, _norm_index(idx, leaf.shape)]
                 for d, idx in sorted(sh.devices_indices_map(leaf.shape).items(),
                                      key=lambda kv: kv[0].id)]
                for leaf, sh in zip(*tree)]

    for name, kw in LAYOUTS.items():
        layout = ShardingLayout(**kw)
        for which, model in models.items():
            state = states[which]
            sh = {}
            for p, plan in plans.items():
                p_sh = param_shardings(model.specs, plan.mesh, layout)
                o_sh = opt_state_shardings(model.specs, plan.mesh, layout)
                repl = jax.sharding.NamedSharding(plan.mesh, jax.sharding.PartitionSpec())
                sh[p] = TrainState(params=p_sh, opt=OptState(m=o_sh, v=o_sh, count=repl),
                                   step=repl)
                if which == "reduced":
                    leaves = jax.tree_util.tree_leaves(state.params)
                    out["maps"][f"{name}/{p}/param"] = maps(
                        (leaves, jax.tree_util.tree_leaves(p_sh)))
                    out["maps"][f"{name}/{p}/opt"] = maps(
                        (leaves, jax.tree_util.tree_leaves(o_sh)))
            b = out["bytes"].setdefault(f"{name}/{which}", {})
            b["tree"] = tree_bytes(state)
            for a in plans:
                for c in plans:
                    b[f"{a}->{c}"] = reshard_bytes(state, sh[a], sh[c])
            for leg in (0, 1):
                b[f"leg{leg}"] = leg_state_bytes(state, sh["4+4"], plans["4+4"], leg)
    print("DIST_JSON " + json.dumps(out))
    """
)


@pytest.fixture(scope="module")
def reference():
    env = {**os.environ, "PYTHONPATH": str(REPO / "src"), "DIST_LAYOUTS": json.dumps(LAYOUTS)}
    res = subprocess.run([sys.executable, "-c", REFERENCE_SCRIPT], capture_output=True,
                         text=True, timeout=300, env=env, cwd=str(REPO))
    for line in res.stdout.splitlines():
        if line.startswith("DIST_JSON "):
            out = json.loads(line[len("DIST_JSON "):])
            assert out["n_devices"] == 8
            return out
    raise AssertionError(f"reference subprocess failed:\n{res.stdout}\n{res.stderr}")


def _plans(man):
    return {"1": man.plan_for(1), "2": man.plan_for(2), "4": man.plan_for(4),
            "8": man.plan_for(8), "4+4": man.plan_for_allocation([4, 4])}


def _state_placements(specs, plan, layout):
    p_sh = param_shardings(specs, plan.mesh, layout)
    o_sh = opt_state_shardings(specs, plan.mesh, layout)
    repl = replicated(plan.mesh)
    return p_sh, o_sh, TrainState(params=p_sh, opt=OptState(m=o_sh, v=o_sh, count=repl),
                                  step=repl)


def _maps(leaves, placements):
    return [[[slot, [list(r) for r in _norm_index(idx, tuple(t.shape))]]
             for slot, idx in sorted(p.indices_map(t.shape).items())]
            for t, p in zip(leaves, placements)]


@pytest.mark.parametrize("layout_name", sorted(LAYOUTS))
def test_placements_and_bytes_match_reference(reference, layout_name):
    layout = ShardingLayout(**LAYOUTS[layout_name])
    man = ElasticMeshManager(["cpu"] * 8)
    plans = _plans(man)
    reduced, full = build_model(get_arch("qwen3-4b").reduced()), build_model(get_arch("qwen3-4b"))
    states = {
        "reduced": init_train_state(reduced, torch.Generator().manual_seed(0), "cpu"),
        # full width: the byte counters need only shapes and dtypes (ParamSpecs)
        "full": TrainState(params=full.specs, opt=OptState(full.specs, full.specs, 0), step=0),
    }
    for which, model in (("reduced", reduced), ("full", full)):
        state = states[which]
        sh = {}
        for p, plan in plans.items():
            p_sh, o_sh, sh[p] = _state_placements(model.specs, plan, layout)
            if which == "reduced":
                leaves = tree_flatten(state.params)[0]
                for kind, tree in (("param", p_sh), ("opt", o_sh)):
                    got = _maps(leaves, tree_flatten(tree)[0])
                    want = reference["maps"][f"{layout_name}/{p}/{kind}"]
                    assert got == want, (layout_name, p, kind)
        ref_bytes = reference["bytes"][f"{layout_name}/{which}"]
        got = {"tree": tree_bytes(state)}
        for a in plans:
            for c in plans:
                got[f"{a}->{c}"] = reshard_bytes(state, sh[a], sh[c])
        for leg in (0, 1):
            got[f"leg{leg}"] = leg_state_bytes(state, sh["4+4"], plans["4+4"], leg)
        assert got == ref_bytes, (layout_name, which)
        # a one-leg rebuild moves no more than a full restore, and strictly
        # fewer where the params shard over the data axis
        for leg in ("leg0", "leg1"):
            assert 0 < got[leg] <= got["tree"]
            if layout.param_rules in ("baseline", "fsdp_heavy"):
                assert got[leg] < got["tree"]


def test_slots_on_one_device_are_told_apart_by_position():
    """Eight slots naming one device: the legs' bytes are those of eight
    distinct devices (a pool keyed by the device object would see one)."""
    model = build_model(get_arch("qwen3-4b").reduced())
    layout = ShardingLayout()
    shared = ElasticMeshManager([torch.device("cpu")] * 8).plan_for_allocation([4, 4])
    state = init_train_state(model, torch.Generator().manual_seed(0), "cpu")
    _, _, sh = _state_placements(model.specs, shared, layout)
    legs = [leg_state_bytes(state, sh, shared, i) for i in (0, 1)]
    assert 0 < legs[0] < tree_bytes(state) and legs[0] + legs[1] >= tree_bytes(state)
    assert shared.mesh.distinct_devices == (torch.device("cpu"),)
    moved = reshard_tree(state, sh)                    # one device: no copy
    assert moved.params["embed"] is state.params["embed"]


def test_reshard_tree_refuses_two_devices():
    man = ElasticMeshManager([torch.device("cpu"), torch.device("meta")])
    plan = man.plan_for(2)
    with pytest.raises(NotImplementedError, match="distinct devices"):
        reshard_tree({"w": torch.zeros(4)}, {"w": replicated(plan.mesh)})


def test_counters_match_reference_in_process():
    for n in list(range(1, 20)) + [256]:
        assert mesh_shape_for(n) == ref_meshplan.mesh_shape_for(n)
    for arch in ("qwen3-4b", "hymba-1.5b", "xlstm-350m"):
        for reduce in (True, False):
            cfg, rcfg = get_arch(arch), ref_get_arch(arch)
            if reduce:
                cfg, rcfg = cfg.reduced(), rcfg.reduced()
            model, ref_model = build_model(cfg), ref_build_model(rcfg)
            assert train_state_bytes(model) == ref_meshplan.train_state_bytes(ref_model)
            for batch, seq in ((1, 64), (8, 4096)):
                assert serve_state_bytes(model, batch, seq) == \
                    ref_meshplan.serve_state_bytes(ref_model, batch, seq)
    # full-width qwen3-4b: f32 params and both AdamW moments
    assert train_state_bytes(build_model(get_arch("qwen3-4b"))) == 52_937_091_072


def test_manager_caps_to_pool_and_caches():
    man = ElasticMeshManager()                    # default pool: one slot, cuda:0
    assert man.devices == [torch.device("cuda", 0)]
    p8, p4 = man.plan_for(8), man.plan_for(4)
    assert p8.device_count == 1 and p8.requested_devices == 8
    assert p8.key == p4.key and p8.mesh is p4.mesh
    pool = ElasticMeshManager(["cpu"] * 8)
    assert pool.plan_for_allocation([16, 16]).leg_spans == ((0, 4), (4, 8))
    assert pool.plan_for_allocation([4, 4]).key == pool.plan_for(8).key
    assert pool.plan_for_allocation([4]) is pool.plan_for(4)


def test_reshard_bytes_zero_for_identical_placements():
    man = ElasticMeshManager(["cpu"] * 4)
    tree = {"w": torch.arange(64.0).reshape(8, 8), "step": 3}
    sh = {"w": Placement(man.plan_for(4).mesh, (("data",), ())),
          "step": replicated(man.plan_for(4).mesh)}
    assert reshard_bytes(tree, sh, sh) == 0
    assert tree_bytes(tree) == 64 * 4 + 4


def test_throughput_tracker_corrects_analytic_model():
    tr = ThroughputTracker()
    analytic = {"a": 1.0, "b": shape_throughput(4)}   # model predicts 3.03×
    assert tr.correction("b", analytic) == 1.0        # nothing measured yet
    tr.observe("a", steps=100, seconds=100.0)         # 1.0 step/s
    assert tr.correction("b", analytic) == 1.0        # single-shape anchor
    tr.observe("b", steps=100, seconds=50.0)          # measured only 2.0×
    c = tr.correction("b", analytic)
    assert c == pytest.approx(2.0 / shape_throughput(4))
    assert c < 1.0                                    # scaled worse than model
    assert tr.correction("a", analytic) == 1.0        # the anchor stays 1.0


def test_tracker_ema_converges():
    tr = ThroughputTracker(ema=0.5)
    for _ in range(10):
        tr.observe("k", steps=10, seconds=2.0)
    assert tr.steps_per_sec("k") == pytest.approx(5.0)
    tr.observe("k", steps=0, seconds=1.0)   # degenerate observations ignored
    tr.observe("k", steps=10, seconds=0.0)
    assert tr.steps_per_sec("k") == pytest.approx(5.0)
