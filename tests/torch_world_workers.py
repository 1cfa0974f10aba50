"""What the ranks of a gloo world run for ``tests/test_torch_multidevice.py``.

Each function is ``fn(world, *args)`` for ``repro_torch.launch.mesh.
run_world``, which spawns the ranks and returns rank 0's result. The
module imports no JAX (a spawned rank imports it by name); every rank
builds the same reduced f32 qwen3-4b and the same state from the
arguments, so their host logic agrees.
"""
import dataclasses
import tempfile

import numpy as np
import torch

from repro_torch.config import ShardingLayout, TrainConfig, get_arch
from repro_torch.core.market import Market, MarketSet
from repro_torch.core.orchestrator import SpotTrainingOrchestrator
from repro_torch.data import SyntheticLM
from repro_torch.dist import ElasticMeshManager, elastic, reshard_bytes, reshard_tree
from repro_torch.models import build_model
from repro_torch.models.common import tree_flatten
from repro_torch.models.convert import params_to_numpy, train_state_from_jax
from repro_torch.optim import OptState
from repro_torch.train.loop import make_step, state_shardings
from repro_torch.train.steps import TrainState

COLUMNS = ("total_steps", "useful_steps", "wasted_steps", "revocations", "markets_used",
           "allocations_used", "leg_repairs", "leg_costs", "cost_dollars", "reshard_bytes",
           "restore_bytes", "reshard_events", "mesh_shapes", "cost_to_complete")
MODES = ("siwoft", "checkpoint", "hybrid")
# four markets of 4, 2, 1 and 4 devices (80 GB each, explicit relative
# rates, so no measured time enters a decision); history ranks them by
# lifetime A > B > C > D, and A, B, C revoke at future hours 4, 8, 12:
# siwoft trains on (2, 2), shrinks to (2, 1) and (1, 1), grows back
SHRINK_MARKETS = [
    ("quad.a", "us-east-1", "us-east-1a", 80, 1.2, 4, 100.0),
    ("pair.b", "eu-west-1", "eu-west-1a", 80, 1.2, 2, 100.0),
    ("one.c", "ap-southeast-1", "ap-southeast-1a", 80, 1.2, 1, 100.0),
    ("quad.d", "us-west-2", "us-west-2a", 80, 1.2, 4, 100.0),
]
SHRINK_RUN = dict(steps=12, segment_steps=3, ckpt_every=2, ft_revocations=2)
# tests/test_torch_orchestrator.py's split scenario (the bench's): a 400 GB
# job on two 8-device legs, capped to 2 + 2 ranks; leg B revokes at future
# hour 2, and the repair rebuilds only that leg
SPLIT_MARKETS = [
    ("big8.a", "us-east-1", "us-east-1a", 40, 1.2, 8, 60.0),
    ("big8.b", "eu-west-1", "eu-west-1a", 40, 1.2, 8, 60.0),
    ("big8.c", "ap-southeast-1", "ap-southeast-1a", 40, 1.2, 8, 60.0),
    ("small1", "us-east-1", "us-east-1b", 64, 0.4, 1, 10.0),
]


def shrink_market_sets():
    markets = [Market(i, *m[:5], device_count=m[5], interconnect_gbps=m[6],
                      steps_per_hour=1.0) for i, m in enumerate(SHRINK_MARKETS)]
    hp = np.full((4, 90), 0.35)
    hp[1, 45] = 1.5
    hp[2, 30::30] = 1.5
    hp[3, 15::15] = 1.5
    fp = np.full((4, 48), 0.35)
    for i, h in enumerate((4, 8, 12)):
        fp[i, h] = 1.5
    return MarketSet(markets, hp), MarketSet(markets, fp, start_hour=90)


def split_market_sets():
    markets = [Market(i, *m[:5], device_count=m[5], interconnect_gbps=m[6])
               for i, m in enumerate(SPLIT_MARKETS)]
    hp = np.full((4, 90), 0.35)
    hp[2, ::45] = 1.5
    hp[3, ::5] = 0.6
    fp = np.full((4, 24), 0.35)
    fp[1, 2:4] = 1.5
    return MarketSet(markets, hp), MarketSet(markets, fp, start_hour=90)


def run_split(init, mesh_manager=None):
    """siwoft on the split scenario from ``init``, as ``run_shrink``."""
    cfg = reduced_f32()
    return SpotTrainingOrchestrator(
        build_model(cfg), SyntheticLM(cfg.vocab_size, 32, 4, seed=0), "cpu",
        *split_market_sets(), mode="siwoft", tc=TrainConfig(total_steps=80, warmup_steps=2),
        layout=ShardingLayout(), segment_steps=10, steps_per_trace_hour=1, seed=0,
        job_memory_gb=400.0, mesh_manager=mesh_manager,
        init_state=lambda: train_state_from_jax(init, cfg, "cpu")).run(40)


def reduced_f32():
    return dataclasses.replace(get_arch("qwen3-4b").reduced(), dtype="float32")


def run_shrink(mode, init, ckpt_dir, mesh_manager=None):
    """The shrink scenario in ``mode`` from the numpy state ``init``, on the
    CPU: over the world's ranks, or over ``mesh_manager``'s pool."""
    cfg = reduced_f32()
    r = SHRINK_RUN
    orch = SpotTrainingOrchestrator(
        build_model(cfg), SyntheticLM(cfg.vocab_size, 32, 4, seed=0), "cpu",
        *shrink_market_sets(), mode=mode, tc=TrainConfig(total_steps=2 * r["steps"],
                                                        warmup_steps=2),
        layout=ShardingLayout(), segment_steps=r["segment_steps"], steps_per_trace_hour=1,
        seed=0, job_memory_gb=40.0, ckpt_dir=ckpt_dir, ckpt_every=r["ckpt_every"],
        ft_revocations=r["ft_revocations"], mesh_manager=mesh_manager,
        init_state=lambda: train_state_from_jax(init, cfg, "cpu"))
    try:
        return orch.run(r["steps"])
    finally:
        if orch.ckpt is not None:
            orch.ckpt.close()


def _sized(model):
    return TrainState(model.specs, OptState(model.specs, model.specs, 0), 0)


def roundtrip(w, init, counts):
    """Place the state on a plan of ``counts[0]`` ranks, move it through
    the others, gather it back to every rank: (each move's plan size,
    bytes received summed over ranks, ``reshard_bytes``), and whether
    every leaf came back bit-equal."""
    cfg = reduced_f32()
    model = build_model(cfg)
    state = train_state_from_jax(init, cfg, "cpu")
    start = [x.clone() if isinstance(x, torch.Tensor) else x for x in tree_flatten(state)[0]]
    man = ElasticMeshManager()
    live = elastic.everywhere(state)
    moves = []
    for i, n in enumerate(counts):
        new = state_shardings(model, man.plan_for(n).mesh, ShardingLayout())
        before = elastic.stats.bytes_received
        state = reshard_tree(state, new, live)
        got = torch.tensor([elastic.stats.bytes_received - before])
        torch.distributed.all_reduce(got)
        if i:
            moves.append((n, int(got), reshard_bytes(_sized(model), live, new)))
        live = new
    back = reshard_tree(state, elastic.everywhere(state), live)
    same = all(torch.equal(a, b) if isinstance(a, torch.Tensor) else a == b
               for a, b in zip(tree_flatten(back)[0], start))
    return moves, same


def step_twice(step, state, batch):
    """Run ``step`` from ``state``, put the state back (the step updates it
    in place) and run it again: (state, metrics, whether the two runs'
    metrics and slices have the same bits)."""
    leaves, unflatten = tree_flatten(state)
    kept = [x.clone() if isinstance(x, torch.Tensor) else x for x in leaves]
    state, first = step(state, batch)
    first = {k: v.clone() for k, v in first.items()}
    after = [x.clone() if isinstance(x, torch.Tensor) else x for x in tree_flatten(state)[0]]
    with torch.no_grad():
        state = unflatten([x.copy_(k) if isinstance(x, torch.Tensor) else k
                           for x, k in zip(tree_flatten(state)[0], kept)])
    state, second = step(state, batch)
    same = all(torch.equal(first[k], second[k]) for k in first) and all(
        torch.equal(a, b) if isinstance(a, torch.Tensor) else a == b
        for a, b in zip(after, tree_flatten(state)[0]))
    return state, second, same


def sharded_steps(w, init, count, n_steps=3):
    """``n_steps`` of the sharded step on a plan of ``count`` ranks from
    ``init``, the first run twice from the same state: each step's
    metrics, the params gathered at the end, the step count and whether
    the twice-run step gave the same bits on every rank."""
    cfg = reduced_f32()
    model = build_model(cfg)
    layout = ShardingLayout(attn_impl="flash")
    plan = ElasticMeshManager().plan_for(count)
    sh = state_shardings(model, plan.mesh, layout)
    state = train_state_from_jax(init, cfg, "cpu")
    state = reshard_tree(state, sh, elastic.everywhere(state))
    step = make_step(model, TrainConfig(total_steps=10, warmup_steps=2), layout, plan.mesh)
    ds = SyntheticLM(256, 32, 4, seed=0)
    metrics, same = [], None
    for i in range(n_steps):
        batch = {k: torch.from_numpy(v) for k, v in ds.batch(i).items()}
        if i == 0:
            state, m, same = step_twice(step, state, batch)
        else:
            state, m = step(state, batch)
        metrics.append({k: float(v) for k, v in m.items()})
    whole = reshard_tree(state, elastic.everywhere(state), sh)
    agree = torch.tensor([int(same)])
    torch.distributed.all_reduce(agree, op=torch.distributed.ReduceOp.MIN)
    return plan.mesh_shape, metrics, params_to_numpy(whole.params), whole.step, bool(agree)


def everything(w, init):
    """The world of 4: the 4 -> 2 -> 4 -> 1 -> 4 roundtrip, three sharded
    steps on (2, 2), the shrink scenario in each mode and the split
    scenario's one-leg repair."""
    out = {"roundtrip": roundtrip(w, init, (4, 2, 4, 1, 4)),
           "steps": sharded_steps(w, init, 4), "modes": {}}
    with tempfile.TemporaryDirectory() as d:
        for mode in MODES:
            rep = run_shrink(mode, init, f"{d}/{mode}")
            out["modes"][mode] = ({k: getattr(rep, k) for k in COLUMNS}, rep.losses, rep.moves)
    rep = run_split(init)
    out["split"] = ({k: getattr(rep, k) for k in COLUMNS}, rep.losses, rep.moves)
    return out


def pair(w, init):
    """The world of 2: the 2 -> 1 -> 2 roundtrip and three sharded steps
    on (2, 1)."""
    return {"roundtrip": roundtrip(w, init, (2, 1, 2)), "steps": sharded_steps(w, init, 2)}


# ---------------------------------------------------------------------------
# Serving over ranks (tests/test_torch_serve_ranks.py)
# ---------------------------------------------------------------------------

SERVE_B, SERVE_S, SERVE_NEW, SERVE_REVOKE = 4, 16, 8, 3
# run -> (arch case, counts, revoke_after, cache_policy, engine, int8 cache)
SERVE_RUNS = {
    "dense": ("qwen", [4], 0, "drop", False, False),
    "drop": ("qwen", [4, 2], SERVE_REVOKE, "drop", False, False),
    "migrate": ("qwen", [4, 2], SERVE_REVOKE, "migrate", False, False),
    "migrate_4_1": ("qwen", [4, 1], SERVE_REVOKE, "migrate", False, False),
    "engine": ("qwen", [4, 2], SERVE_REVOKE, "drop", True, False),
    "grow": ("qwen", [2, 4], SERVE_REVOKE, "migrate", False, False),
    "int8_migrate": ("qwen", [4, 2], SERVE_REVOKE, "migrate", False, True),
    "whisper_migrate": ("whisper", [4, 2], SERVE_REVOKE, "migrate", False, False),
}
# the host path over ranks: the reduced bf16 model the launcher serves
HOST_ARGV = ["--arch", "qwen3-4b", "--batch", str(SERVE_B), "--prompt-len", str(SERVE_S),
             "--new-tokens", str(SERVE_NEW), "--device", "cpu", "--seed", "0"]


def serve_case(case, qwen_params):
    """(model, params, prompts, frames) of a serving case, alike on every
    rank and in the test's process: reduced f32 qwen3-4b with the
    reference's weights (numpy), or reduced f32 whisper-tiny from the
    seeded torch generator with its frames drawn after the params."""
    from repro_torch.models.convert import params_from_jax

    arch = "qwen3-4b" if case == "qwen" else "whisper-tiny"
    cfg = dataclasses.replace(get_arch(arch).reduced(), dtype="float32")
    model = build_model(cfg)
    prompts = np.random.RandomState(0).randint(
        0, cfg.vocab_size, (SERVE_B, SERVE_S)).astype(np.int32)
    if case == "qwen":
        return model, params_from_jax(qwen_params, cfg, "cpu"), prompts, None
    gen = torch.Generator().manual_seed(0)
    params = model.init(gen, "cpu")
    frames = torch.randn((SERVE_B, cfg.encoder_seq_len, cfg.d_model), generator=gen)
    return model, params, prompts, frames


def serve_one(run, qwen_params, cases=None):
    """One of SERVE_RUNS through ``serve_plan``: over the world's ranks
    when this process is a rank, else over a pool of 4 CPU slots."""
    from repro_torch.launch import serve

    case, counts, revoke, policy, engine, int8 = SERVE_RUNS[run]
    model, params, prompts, frames = (cases or {}).get(case) or serve_case(case, qwen_params)
    return serve.serve_plan(model, params, prompts, SERVE_NEW, counts, revoke_after=revoke,
                            cache_policy=policy, engine=engine, device="cpu",
                            int8_cache=int8, frames=frames)


def serve_ranks(w, qwen_params, trace_path):
    """The world of 4: every run of SERVE_RUNS, then the CLI: the host path
    with ``--devices 4 --model-parallel 2``, and the engine on plans 4 -> 2
    recording its trace to ``trace_path`` (rank 0 records)."""
    from repro_torch.launch import serve

    cases = {c: serve_case(c, qwen_params) for c in ("qwen", "whisper")}
    out = {run: serve_one(run, qwen_params, cases) for run in SERVE_RUNS}
    out["host"] = serve.main(HOST_ARGV + ["--devices", "4", "--model-parallel", "2"])
    out["traced"] = serve.main(HOST_ARGV + ["--devices", "4", "--plan", "4,2", "--revoke-after",
                                            str(SERVE_REVOKE), "--engine", "--trace",
                                            trace_path])
    return out
