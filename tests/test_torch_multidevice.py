"""The port's multi-device execution (``repro_torch.launch.mesh``,
``dist.elastic``'s moves between ranks, the sharded train step and the
orchestrator over ranks) in gloo worlds of 2 and 4 ranks on the CPU.

Reduced qwen3-4b in f32 from the reference's ``init_train_state(model,
jax.random.key(0))``. Each world is spawned once, module-scoped
(``tests/torch_world_workers.py`` holds what its ranks run), with its own
file store under ``tmp_path`` and its own timeout. Held:

* a 4 -> 2 -> 4 -> 1 -> 4 (and 2 -> 1 -> 2) roundtrip gives every leaf
  bit-equal to the start, as ``tests/test_meshplan.py`` holds the
  reference's; each move's bytes received, summed over ranks, equal
  ``reshard_bytes`` exactly;
* three sharded steps on (2, 2) and (2, 1): loss and grad norm against
  the one-device step and the reference's ``build_train_step(...,
  constrain=None)`` at rtol 1e-4, params at atol 1e-5 (sharding does not
  change the function; the sums run in other orders); the first step run
  twice from one state gives the same bits on every rank;
* the orchestrator's three modes over 4 ranks on a scenario that trains on
  (2, 2), shrinks to (2, 1) and (1, 1) and grows back, and siwoft on the
  split scenario (a one-leg repair): report columns ``==`` the port's
  one-process run over a pool of 4 slots (held to the reference by
  ``tests/test_torch_orchestrator.py``), losses at rtol 1e-4, and every
  live reshard's and leg rebuild's bytes received ``==`` its priced bytes.
"""
import contextlib
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import torch_world_workers as workers
from repro.config import ShardingLayout as JaxLayout
from repro.config import TrainConfig as JaxTrainConfig
from repro.config import get_arch as jax_get_arch
from repro.data import SyntheticLM as JaxSyntheticLM
from repro.models import build_model as jax_build_model
from repro.train import steps as jax_steps
from repro_torch.config import ShardingLayout, TrainConfig
from repro_torch.data import SyntheticLM
from repro_torch.dist import ElasticMeshManager, placement_device, replicated, reshard_tree
from repro_torch.launch import mesh as launch_mesh
from repro_torch.models import build_model
from repro_torch.models.convert import params_to_numpy, train_state_from_jax
from repro_torch.optim import OptState
from repro_torch.train import steps
from repro_torch.train.steps import TrainState

LOSS_RTOL = 1e-4
PARAM_ATOL = 1e-5
WORLD_TIMEOUT = 300


@contextlib.contextmanager
def _one_thread():
    """The in-process runs on one intra-op thread: beside the suite's other
    workers, more threads than cores made them 40x slower."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    try:
        yield
    finally:
        torch.set_num_threads(threads)


@pytest.fixture(scope="module")
def init():
    """The reference's initial state as numpy, in the port's TrainState."""
    cfg = dataclasses.replace(jax_get_arch("qwen3-4b").reduced(), dtype="float32")
    s = jax.tree_util.tree_map(np.asarray,
                               jax_steps.init_train_state(jax_build_model(cfg), jax.random.key(0)))
    return TrainState(s.params, OptState(s.opt.m, s.opt.v, int(s.opt.count)), int(s.step))


def _world(tmp_path_factory, fn, n, init):
    store = tmp_path_factory.mktemp(f"world{n}") / "store"
    return launch_mesh.run_world(fn, n, "cpu", (init,), timeout=WORLD_TIMEOUT,
                                 init_method=f"file://{store}", threads=1)


@pytest.fixture(scope="module")
def world4(tmp_path_factory, init):
    return _world(tmp_path_factory, workers.everything, 4, init)


@pytest.fixture(scope="module")
def world2(tmp_path_factory, init):
    return _world(tmp_path_factory, workers.pair, 2, init)


@pytest.fixture(scope="module")
def one_device(init):
    """Three one-device steps of the port and of the reference."""
    with _one_thread():
        return _one_device(init)


def _one_device(init):
    cfg = workers.reduced_f32()
    step = steps.build_train_step(build_model(cfg), TrainConfig(total_steps=10, warmup_steps=2),
                                  ShardingLayout(attn_impl="flash"))
    state = train_state_from_jax(init, cfg, "cpu")
    ds = SyntheticLM(256, 32, 4, seed=0)
    port = []
    for i in range(3):
        state, m = step(state, {k: torch.from_numpy(v) for k, v in ds.batch(i).items()})
        port.append({k: float(v) for k, v in m.items()})
    jcfg = dataclasses.replace(jax_get_arch("qwen3-4b").reduced(), dtype="float32")
    jstep = jax.jit(jax_steps.build_train_step(
        jax_build_model(jcfg), JaxTrainConfig(total_steps=10, warmup_steps=2),
        JaxLayout(attn_impl="flash"), constrain=None))
    js = jax_steps.TrainState(
        params=jax.tree_util.tree_map(jnp.asarray, init.params),
        opt=jax_steps.OptState(m=jax.tree_util.tree_map(jnp.asarray, init.opt.m),
                               v=jax.tree_util.tree_map(jnp.asarray, init.opt.v),
                               count=jnp.asarray(init.opt.count, jnp.int32)),
        step=jnp.asarray(init.step, jnp.int32))
    jds = JaxSyntheticLM(256, 32, 4, seed=0)
    ref = []
    for i in range(3):
        js, m = jstep(js, {k: jnp.asarray(v) for k, v in jds.batch(i).items()})
        ref.append({k: float(v) for k, v in m.items()})
    return port, params_to_numpy(state.params), ref, jax.tree_util.tree_map(np.asarray, js.params)


@pytest.fixture(scope="module")
def one_process(init, tmp_path_factory):
    """The shrink scenario in each mode over a pool of 4 CPU slots."""
    out = {}
    with _one_thread():
        for mode in workers.MODES:
            rep = workers.run_shrink(mode, init, str(tmp_path_factory.mktemp(mode)),
                                     ElasticMeshManager(["cpu"] * 4))
            out[mode] = ({k: getattr(rep, k) for k in workers.COLUMNS}, rep.losses, rep.moves)
    return out


@pytest.fixture(scope="module")
def one_process_split(init):
    with _one_thread():
        rep = workers.run_split(init, ElasticMeshManager(["cpu"] * 4))
    return {k: getattr(rep, k) for k in workers.COLUMNS}, rep.losses


@pytest.mark.parametrize("n", [4, 2])
def test_roundtrip_is_bit_exact(world4, world2, n):
    moves, same = (world4 if n == 4 else world2)["roundtrip"]
    assert same
    assert [m[0] for m in moves] == ([2, 4, 1, 4] if n == 4 else [1, 2])


@pytest.mark.parametrize("n", [4, 2])
def test_move_receives_exactly_reshard_bytes(world4, world2, n):
    moves, _ = (world4 if n == 4 else world2)["roundtrip"]
    for count, received, priced in moves:
        assert received == priced > 0, (count, received, priced)


def _leaves(tree):
    return jax.tree_util.tree_leaves(tree)


@pytest.mark.parametrize("n", [4, 2])
def test_sharded_step_matches_one_device_and_reference(world4, world2, one_device, n):
    shape, metrics, params, step, same = (world4 if n == 4 else world2)["steps"]
    assert shape == ((2, 2) if n == 4 else (2, 1)) and step == 3
    assert same                     # the step run twice from one state: the same bits
    port, port_params, ref, ref_params = one_device
    for got, one, want in zip(metrics, port, ref):
        for k in ("loss", "grad_norm", "aux_loss", "lr"):
            np.testing.assert_allclose(got[k], one[k], rtol=LOSS_RTOL, err_msg=k)
            np.testing.assert_allclose(got[k], want[k], rtol=LOSS_RTOL, err_msg=k)
    for a, b, c in zip(_leaves(params), _leaves(port_params), _leaves(ref_params)):
        np.testing.assert_allclose(a, b, atol=PARAM_ATOL, rtol=0)
        np.testing.assert_allclose(a, c, atol=PARAM_ATOL, rtol=0)


@pytest.mark.parametrize("mode", workers.MODES)
def test_orchestrator_over_ranks_equals_one_process(world4, one_process, mode):
    cols, losses, moves = world4["modes"][mode]
    want, want_losses, want_moves = one_process[mode]
    assert cols == want
    np.testing.assert_allclose(losses, want_losses, rtol=LOSS_RTOL, atol=0)
    assert want_moves == []                     # a pool in one process moves nothing
    assert cols["useful_steps"] == workers.SHRINK_RUN["steps"]


def test_shrink_scenario_moves_what_it_prices(world4):
    """siwoft trains on (2, 2), (2, 1), (1, 1) and (2, 2) again, re-executes
    the steps a revocation cut, and every live reshard receives exactly
    the bytes it was priced at, summing to the report's column."""
    cols, _, moves = world4["modes"]["siwoft"]
    assert cols["mesh_shapes"][::2] == [(2, 2), (2, 1), (1, 1), (2, 2)]
    assert cols["wasted_steps"] > 0 and cols["revocations"] == 3
    reshards = [m for m in moves if m["kind"] == "reshard"]
    assert [m["to"] for m in reshards] == [(2, 1), (1, 1), (2, 2)]
    assert all(m["received"] == m["priced"] > 0 and m["seconds"] > 0 for m in reshards)
    assert sum(m["priced"] for m in reshards) == cols["reshard_bytes"]


def test_mesh_builders_without_a_world():
    assert launch_mesh.world() is None
    mesh = launch_mesh.make_host_mesh(device="cpu")
    assert mesh.grid_shape == (1, 1) and not mesh.distributed
    assert launch_mesh.make_mesh((1, 1), ("data", "model"), "cpu").devices == (torch.device("cpu"),)
    with pytest.raises(ValueError, match="world of 4"):
        launch_mesh.make_mesh((2, 2), ("data", "model"), "cpu")
    with pytest.raises(ValueError, match="256 ranks"):
        launch_mesh.make_production_mesh()
    with pytest.raises(ValueError, match="512 ranks"):
        launch_mesh.make_production_mesh(multi_pod=True)


def test_pool_in_one_process_still_refuses_two_devices():
    """With no world, a pool naming two devices is no world of ranks: the
    placement has no one device, and a move onto it raises."""
    plan = ElasticMeshManager([torch.device("cpu"), torch.device("meta")]).plan_for(2)
    with pytest.raises(NotImplementedError, match="distinct devices"):
        placement_device(replicated(plan.mesh))
    with pytest.raises(NotImplementedError, match="world of ranks"):
        reshard_tree({"w": torch.zeros(4)}, {"w": replicated(plan.mesh)})


def test_leg_repair_rebuilds_what_it_prices(world4, one_process_split):
    """The split scenario over 4 ranks (two legs of 2): leg B's revocation
    is repaired by rebuilding that leg alone, whose ranks receive exactly
    the bytes ``leg_state_bytes`` priced; the run equals the one-process
    pool of 4 slots."""
    cols, losses, moves = world4["split"]
    want, want_losses = one_process_split
    assert cols == want and cols["leg_repairs"] >= 1
    np.testing.assert_allclose(losses, want_losses, rtol=LOSS_RTOL, atol=0)
    legs = [m for m in moves if m["kind"] == "leg"]
    assert len(legs) == cols["leg_repairs"]
    assert all(m["received"] == m["priced"] > 0 for m in legs)
    assert sum(m["priced"] for m in legs) == cols["reshard_bytes"]
