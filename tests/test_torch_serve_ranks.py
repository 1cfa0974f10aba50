"""The port's serving over the ranks of a ``torch.distributed`` world
(``repro_torch.launch.serve``'s plan modes and host path, ``serve.migrate``'s
cache move, ``dist.elastic``'s gather) in one gloo world of 4 ranks on the
CPU.

Reduced qwen3-4b in f32 from the reference's ``Model.init(jax.random.key(0))``
at batch 4, prompt 16, 8 new tokens, revoked after 3 (and the int8 cache,
and reduced f32 whisper-tiny with its frames), as
``tests/test_torch_serve_plan.py`` runs them. The world is spawned once,
module-scoped (``tests/torch_world_workers.py::serve_ranks`` holds what its
ranks run), with its own file store and timeout. Held:

* every stream ``==`` the port's one-process ``serve_plan`` on a pool of 4
  slots (which ``tests/test_torch_serve_plan.py`` holds to the reference's
  greedy decoding), and so are the byte columns;
* each move's bytes received, summed over ranks, ``==`` its priced
  ``params_bytes`` and ``cache_bytes``; the gather of the moved cache to the
  new plan's rows receives ``reshard_bytes`` between those placements;
* the revoked runs measure a rate on both plans; the ranks of a ``data``
  coordinate give the same tokens; each rank prefills and steps only while
  it is in a plan;
* ``--devices 4 --model-parallel 2`` on the host path gives each ``data``
  coordinate's rows the bits the one-device host path gives those rows
  alone (the same batch size, so no near-tie can excuse a difference);
* ``--engine --trace`` over the ranks: rank 0 records its engines' lane
  events and one ``Drain`` of every moved stream, and the trace replays.
"""
import contextlib
import dataclasses

import jax
import numpy as np
import pytest
import torch

import torch_world_workers as workers
from repro.config import get_arch as jax_get_arch
from repro.models import build_model as jax_build_model
from repro_torch.config import ShardingLayout, get_arch
from repro_torch.dist import (
    ElasticMeshManager,
    batch_shardings,
    cache_shardings,
    reshard_bytes,
    rows_shardings,
)
from repro_torch.launch import mesh as launch_mesh
from repro_torch.launch import serve
from repro_torch.models import build_model, common
from repro_torch.obs import events as E
from repro_torch.obs import read_jsonl, replay

WORLD_TIMEOUT = 300
BYTE_COLUMNS = ("plans", "params_bytes", "cache_bytes", "train_path_bytes", "migrated_at",
                "cache_policy")
REVOKED = [r for r, spec in workers.SERVE_RUNS.items() if spec[2]]
MIGRATED = [r for r in REVOKED if workers.SERVE_RUNS[r][3] == "migrate"]


@contextlib.contextmanager
def _one_thread():
    """The in-process runs on one intra-op thread, as each rank runs."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    try:
        yield
    finally:
        torch.set_num_threads(threads)


@pytest.fixture(scope="module")
def qwen_params():
    cfg = dataclasses.replace(jax_get_arch("qwen3-4b").reduced(), dtype="float32")
    return jax.tree_util.tree_map(np.asarray, jax_build_model(cfg).init(jax.random.key(0)))


@pytest.fixture(scope="module")
def trace_path(tmp_path_factory):
    return tmp_path_factory.mktemp("serve_trace") / "engine.jsonl"


@pytest.fixture(scope="module")
def world4(tmp_path_factory, qwen_params, trace_path):
    store = tmp_path_factory.mktemp("serve_world4") / "store"
    return launch_mesh.run_world(workers.serve_ranks, 4, "cpu", (qwen_params, str(trace_path)),
                                 timeout=WORLD_TIMEOUT, init_method=f"file://{store}",
                                 threads=1)


@pytest.fixture(scope="module")
def one_process(qwen_params):
    """Every run over a pool of 4 CPU slots in this process."""
    cases = {c: workers.serve_case(c, qwen_params) for c in ("qwen", "whisper")}
    with _one_thread():
        return {run: workers.serve_one(run, qwen_params, cases) for run in workers.SERVE_RUNS}


@pytest.mark.parametrize("run", list(workers.SERVE_RUNS))
def test_streams_equal_one_process_pool(world4, one_process, run):
    assert world4[run]["tokens"] == one_process[run]["tokens"]
    assert len(world4[run]["tokens"]) == workers.SERVE_B
    assert all(len(row) == workers.SERVE_NEW for row in world4[run]["tokens"])


@pytest.mark.parametrize("run", list(workers.SERVE_RUNS))
def test_byte_columns_equal_one_process_pool(world4, one_process, run):
    got, want = world4[run], one_process[run]
    assert {k: got[k] for k in BYTE_COLUMNS} == {k: want[k] for k in BYTE_COLUMNS}
    assert got.get("engine", False) == want.get("engine", False)


@pytest.mark.parametrize("run", REVOKED)
def test_moves_receive_what_they_price(world4, run):
    """Summed over the ranks, the params' move receives ``params_bytes``
    and the cache's ``cache_bytes``: nothing under drop, which re-prefills."""
    out = world4[run]
    assert out["migrated_at"] == workers.SERVE_REVOKE
    assert out["params_received"] == out["params_bytes"] > 0
    assert 0 < out["params_bytes"] < out["train_path_bytes"]
    assert out["cache_received"] == out["cache_bytes"]
    assert (out["cache_bytes"] > 0) == (out["cache_policy"] == "migrate")
    assert set(out["move_seconds"]) == ({"params", "params_gather", "cache", "cache_gather"}
                                        if out["cache_policy"] == "migrate"
                                        else {"params", "params_gather"})
    assert all(s >= 0 for s in out["move_seconds"].values())


@pytest.mark.parametrize("run", MIGRATED)
def test_cache_gather_receives_reshard_bytes(world4, run):
    """The moved cache, gathered from the new plan's ``cache_shardings``
    to its rows, receives ``reshard_bytes`` between the two: nothing where
    the new plan's model axis is 1 (each slice already holds its rows at
    full length), the other half of the sequence where a plan grows to
    (2, 2)."""
    case, counts, _, _, _, int8 = workers.SERVE_RUNS[run]
    model = workers.serve_case(case, None)[0] if case == "whisper" else build_model(
        dataclasses.replace(get_arch("qwen3-4b").reduced(), dtype="float32"))
    c_specs = model.cache_specs(workers.SERVE_B, workers.SERVE_S + workers.SERVE_NEW,
                                int8=int8)
    mesh = ElasticMeshManager(["cpu"] * 4).plan_for(counts[1]).mesh
    want = reshard_bytes(c_specs, cache_shardings(c_specs, mesh, ShardingLayout()),
                         rows_shardings(c_specs, mesh))
    assert world4[run]["cache_gather_bytes"] == want
    assert (want > 0) == (run == "grow")


@pytest.mark.parametrize("run", REVOKED)
def test_revoked_runs_measure_both_plans(world4, run):
    counts = workers.SERVE_RUNS[run][1]
    keys = {{4: "2x2", 2: "2x1", 1: "1x1"}[n] for n in counts}
    sps = world4[run]["measured_steps_per_sec"]
    assert set(sps) == keys and min(sps.values()) > 0
    assert world4[run]["recover_seconds"] > 0


@pytest.mark.parametrize("run", list(workers.SERVE_RUNS))
def test_ranks_of_a_data_coordinate_agree(world4, run):
    """Every rank of a ``data`` coordinate gave its leader's tokens; a rank
    prefills and decodes only on the plans it is in (dense: one prefill,
    and under drop one re-prefill on the new plan; the engine a prefill a
    request it takes)."""
    out = world4[run]
    _, counts, revoke, policy, engine, _ = workers.SERVE_RUNS[run]
    assert out["data_ranks_agree"]
    new = workers.SERVE_NEW - 1
    for r in out["ranks"]:
        in_old = r["rank"] < counts[0]
        in_new = r["rank"] < counts[-1]
        if not revoke:
            steps = new
        else:
            steps = revoke * in_old + (new - revoke) * in_new
        assert r["decode_steps"] == steps, (r, steps)
        if engine:
            rows = workers.SERVE_B // 2
            assert r["prefills"] == rows * in_old + rows * in_new
        else:
            assert r["prefills"] == in_old + (in_new and policy == "drop" and bool(revoke))


def test_host_path_over_ranks_equals_rows_alone(world4):
    """``--devices 4 --model-parallel 2``: a (2, 2) mesh, each ``data``
    coordinate's 2 rows served on its ranks, equal to the one-device host
    path on those rows alone."""
    out = world4["host"]
    assert out["mesh"] == [2, 2] and out["devices"] == 4 and out["data_ranks_agree"]
    cfg = get_arch("qwen3-4b").reduced()
    model = build_model(cfg)
    with _one_thread():
        params = model.init(torch.Generator(device="cpu").manual_seed(0), "cpu",
                            common.torch_dtype(cfg.dtype))
        prompts = torch.as_tensor(np.random.RandomState(0).randint(
            0, cfg.vocab_size, (workers.SERVE_B, workers.SERVE_S)).astype(np.int32))
        layout = ShardingLayout(attn_impl="flash")
        for rows in (slice(0, 2), slice(2, 4)):
            alone = serve.greedy_serve(model, params, prompts[rows], workers.SERVE_NEW, layout)
            assert out["tokens"][rows] == alone.tokens.tolist()
    assert out["first_row"] == out["tokens"][0]


def test_engine_trace_over_ranks(world4, trace_path):
    """``--engine --trace`` in a world: rank 0 records its own engines'
    lane events (its 2 rows on each plan) and one ``Drain`` of every
    stream the revocation moved; the trace replays."""
    out = world4["traced"]
    assert out["engine"] and out["migrated_at"] == workers.SERVE_REVOKE
    assert out["params_received"] == out["params_bytes"] > 0
    events = read_jsonl(trace_path)
    drains = [e for e in events if isinstance(e, E.Drain)]
    assert len(drains) == 1 and drains[0].moved_requests == workers.SERVE_B
    assert sum(isinstance(e, E.Admit) for e in events) == 2 + 2
    assert sum(isinstance(e, E.Shed) for e in events) == 2
    assert replay.main([str(trace_path)]) == 0


def test_rows_shardings_place_the_batch_only():
    """The rows placement: the batch over ``data``, every other dim whole,
    on the same rows as the inputs' ``batch_shardings``."""
    mesh = ElasticMeshManager(["cpu"] * 4).plan_for(4).mesh
    specs = build_model(get_arch("whisper-tiny").reduced()).cache_specs(4, 24, int8=True)
    rows = common.tree_flatten(rows_shardings(specs, mesh))[0]
    for spec, p in zip(common.tree_flatten(specs)[0], rows):
        want = tuple(("data",) if a == "batch" else () for a in spec.axes)
        assert p.spec == want, (spec.axes, p.spec)
    tokens = batch_shardings({"t": np.zeros((4, 3))}, mesh)["t"]
    for slot in mesh.slots:
        assert rows[0].box(specs["blocks"]["k"].shape, slot)[1] == tokens.box((4, 3), slot)[0]


def test_model_parallel_needs_a_world_it_divides():
    assert launch_mesh.world() is None
    with pytest.raises(ValueError, match="model axis of 2"):
        launch_mesh.make_host_mesh(2, device="cpu")
    with pytest.raises(SystemExit, match="host path"):
        serve.main(workers.HOST_ARGV + ["--plan", "4,2", "--model-parallel", "2"])
