"""The port's serve launcher on mesh plans (``repro_torch.launch.serve``
``--plan`` / ``--engine`` / ``--trace``) against the JAX package's.

Reduced qwen3-4b at batch 4, prompt 16, 8 new tokens, revoked after 3,
as ``tests/test_serve_plan.py`` runs the reference:

* the byte columns and ``migrated_at`` equal the reference's ``PLAN_JSON``
  from one 8-device subprocess (``--plan 8,4`` under drop and migrate);
  the engine path's ``params_bytes`` equals the dense path's (the
  reference's engine cannot run under this JAX version);
* with weights carried over from ``Model.init(jax.random.key(0))`` at
  f32, the port's uninterrupted streams equal greedy decoding by the
  reference's ``Model.prefill`` and ``decode_step``, and the migrate,
  drop and engine round trips equal the uninterrupted stream in full;
* ``drain_replica`` moves every stream and emits one ``Drain``; the flag
  rules and ``--trace`` behave as in the reference.
"""
import dataclasses
import importlib.util
import json
import os
from pathlib import Path
import subprocess
import sys
import textwrap

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.config import get_arch as jax_get_arch
from repro.models import build_model as jax_build_model
from repro_torch.config import ShardingLayout, get_arch
from repro_torch.dist import ElasticMeshManager, cache_shardings, param_shardings, reshard_bytes
from repro_torch.dist import train_state_bytes
from repro_torch.launch import serve
from repro_torch.models import build_model
from repro_torch.models.convert import params_from_jax
from repro_torch.obs import events as E
from repro_torch.obs import read_jsonl, replay
from repro_torch.obs.recorder import recording
from repro_torch.serve import DecodeEngine, Request, drain_replica
from repro_torch.serve.migrate import migrate_cache

REPO = Path(__file__).resolve().parents[1]
B, S, NEW, REVOKE = 4, 16, 8, 3
BASE = ["--arch", "qwen3-4b", "--batch", str(B), "--prompt-len", str(S),
        "--new-tokens", str(NEW), "--device", "cpu"]
BYTE_COLUMNS = ("plans", "params_bytes", "cache_bytes", "train_path_bytes", "migrated_at",
                "cache_policy")

REFERENCE_SCRIPT = textwrap.dedent(
    """
    import os
    os.environ["XLA_FLAGS"] = "--xla_force_host_platform_device_count=8"
    import contextlib, io, json, sys
    from repro.config import ShardingLayout, get_arch
    from repro.dist import ElasticMeshManager, cache_shardings, param_shardings
    from repro.dist.meshplan import reshard_bytes, train_state_bytes
    from repro.launch import serve
    from repro.models import build_model

    def plan_json(argv):
        out = io.StringIO()
        sys.argv = ["serve"] + argv
        with contextlib.redirect_stdout(out):
            serve.main()
        for line in out.getvalue().splitlines():
            if line.startswith("PLAN_JSON "):
                return json.loads(line[len("PLAN_JSON "):])
        raise AssertionError(out.getvalue())

    base = ["--arch", "qwen3-4b", "--batch", "%d", "--prompt-len", "%d",
            "--new-tokens", "%d"]
    res = {p: plan_json(base + ["--plan", "8,4", "--revoke-after", "%d",
                                "--cache-policy", p]) for p in ("drop", "migrate")}
    # the full-width serving state's placements on the same two plans
    model = build_model(get_arch("qwen3-4b"))
    man, layout = ElasticMeshManager(), ShardingLayout()
    old, new = man.plan_for(8).mesh, man.plan_for(4).mesh
    c_specs = model.cache_specs(8, 2032)
    res["full_width"] = {
        "params_bytes": reshard_bytes(model.specs, param_shardings(model.specs, old, layout),
                                      param_shardings(model.specs, new, layout)),
        "cache_bytes": reshard_bytes(c_specs, cache_shardings(c_specs, old, layout),
                                     cache_shardings(c_specs, new, layout)),
        "train_path_bytes": train_state_bytes(model),
    }
    print("REF_JSON " + json.dumps(res))
    """ % (B, S, NEW, REVOKE)
)


@pytest.fixture(scope="module")
def reference():
    res = subprocess.run([sys.executable, "-c", REFERENCE_SCRIPT], capture_output=True,
                         text=True, timeout=600, cwd=str(REPO),
                         env={**os.environ, "PYTHONPATH": str(REPO / "src")})
    for line in res.stdout.splitlines():
        if line.startswith("REF_JSON "):
            return json.loads(line[len("REF_JSON "):])
    raise AssertionError(res.stdout + res.stderr)


@pytest.fixture(scope="module")
def f32():
    """Reduced f32 qwen3-4b in both packages, the same weights, and the
    reference's greedy stream (``Model.prefill`` + ``decode_step``)."""
    jcfg = dataclasses.replace(jax_get_arch("qwen3-4b").reduced(), dtype="float32")
    cfg = dataclasses.replace(get_arch("qwen3-4b").reduced(), dtype="float32")
    jm = jax_build_model(jcfg)
    jp = jm.init(jax.random.key(0))
    model = build_model(cfg)
    params = params_from_jax(jax.tree_util.tree_map(np.asarray, jp), cfg, "cpu")
    prompts = np.random.RandomState(0).randint(0, cfg.vocab_size, (B, S)).astype(np.int32)
    logits, cache = jm.prefill(jp, {"tokens": jnp.asarray(prompts)}, S + NEW)
    tok = jnp.argmax(logits[:, -1], axis=-1).astype(jnp.int32)[:, None]
    toks = [np.asarray(tok)]
    for i in range(NEW - 1):
        logits, cache = jm.decode_step(jp, cache, tok, jnp.int32(S + i))
        tok = jnp.argmax(logits[:, -1], axis=-1).astype(jnp.int32)[:, None]
        toks.append(np.asarray(tok))
    oracle = np.concatenate(toks, axis=1).tolist()
    return model, params, prompts, oracle


def _serve(f32, counts, **kw):
    model, params, prompts, _ = f32
    return serve.serve_plan(model, params, prompts, NEW, counts, device="cpu", **kw)


# --- byte columns against the reference's PLAN_JSON -----------------------------

@pytest.mark.parametrize("policy", ["drop", "migrate"])
def test_plan_byte_columns_equal_reference(reference, policy):
    """The tree the reference serves (f32 params, bf16 compute)."""
    jcfg = jax_get_arch("qwen3-4b").reduced()
    cfg = get_arch("qwen3-4b").reduced()
    jp = jax_build_model(jcfg).init(jax.random.key(0))
    params = params_from_jax(jax.tree_util.tree_map(np.asarray, jp), cfg, "cpu")
    prompts = np.random.RandomState(1).randint(0, cfg.vocab_size, (B, S)).astype(np.int32)
    out = serve.serve_plan(build_model(cfg), params, prompts, NEW, [8, 4], revoke_after=REVOKE,
                           cache_policy=policy, device="cpu")
    ref = reference[policy]
    assert {k: out[k] for k in BYTE_COLUMNS} == {k: ref[k] for k in BYTE_COLUMNS}
    assert out["migrated_at"] == REVOKE and 0 < out["params_bytes"] < out["train_path_bytes"]
    assert (out["cache_bytes"] > 0) == (policy == "migrate")
    assert set(out["measured_steps_per_sec"]) == set(ref["measured_steps_per_sec"]) == \
        {"4x2", "2x2"}


@pytest.mark.parametrize("form", [["--cache-policy", "drop"], ["--cache-policy", "migrate"],
                                  ["--engine"]], ids=["drop", "migrate", "engine"])
def test_cli_plan_byte_columns_equal_reference(reference, form, capsys):
    out = serve.main(BASE + ["--plan", "8,4", "--revoke-after", str(REVOKE)] + form)
    lines = capsys.readouterr().out.splitlines()
    printed = json.loads(next(l for l in lines if l.startswith("PLAN_JSON "))[10:])
    assert printed == json.loads(json.dumps(out))
    assert any(l.startswith("first row: ") for l in lines)
    ref = reference["migrate" if "migrate" in form else "drop"]
    assert {k: out[k] for k in BYTE_COLUMNS} == {k: ref[k] for k in BYTE_COLUMNS}
    assert out["recover_seconds"] > 0
    if "--engine" in form:
        assert out["engine"] is True and out["engine_tokens_per_sec"] > 0
        assert out["prefills"] == 2 * B


def _chip_smoke():
    spec = importlib.util.spec_from_file_location("chip_smoke", REPO / "chip_smoke.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def test_full_width_byte_counts_equal_reference_and_chip_prediction(reference):
    """The full-width counts the card's run is held to (chip_smoke.py's
    prediction): f32 params and the bf16 cache equal the reference's on
    the same specs and plans; the bf16 params' count is the port's own."""
    model = build_model(get_arch("qwen3-4b"))
    man = ElasticMeshManager([torch.device("cpu")] * 8)
    layout = serve.PLAN_LAYOUT
    old, new = man.plan_for(8).mesh, man.plan_for(4).mesh
    c_specs = model.cache_specs(8, 2032)
    ours = {
        "params_bytes": reshard_bytes(model.specs, param_shardings(model.specs, old, layout),
                                      param_shardings(model.specs, new, layout)),
        "cache_bytes": reshard_bytes(c_specs, cache_shardings(c_specs, old, layout),
                                     cache_shardings(c_specs, new, layout)),
        "train_path_bytes": train_state_bytes(model),
    }
    assert ours == reference["full_width"]
    predicted = _chip_smoke().serve_plan_predicted(model)
    assert predicted["cache_bytes"] == ours["cache_bytes"]
    # 3 x the f32 params; a TrainState snapshot adds the step and the moment
    # count, 8 bytes more (52,937,091,080)
    assert predicted["train_path_bytes"] == ours["train_path_bytes"] == 52_937_091_072
    assert 0 < predicted["params_bytes"] < ours["params_bytes"]


# --- streams at f32 -------------------------------------------------------------

@pytest.mark.parametrize("engine", [False, True], ids=["dense", "engine"])
def test_f32_uninterrupted_stream_equals_reference_greedy(f32, engine):
    out = _serve(f32, [8], engine=engine)
    assert out["tokens"] == f32[3]
    assert out["migrated_at"] is None and out["params_bytes"] == 0
    assert out["recover_seconds"] is None


@pytest.mark.parametrize("kw", [dict(cache_policy="drop"), dict(cache_policy="migrate"),
                                dict(engine=True)], ids=["drop", "migrate", "engine"])
def test_f32_revoked_stream_equals_uninterrupted(f32, kw):
    out = _serve(f32, [8, 4], revoke_after=REVOKE, **kw)
    assert out["tokens"] == f32[3]
    assert out["migrated_at"] == REVOKE
    assert out["decode_steps"] == NEW - 1 and out["recover_seconds"] > 0


def test_engine_resume_fits_the_pool_sized_for_the_stream(f32):
    """prompt + max_new = 32 positions fill exactly 2 pages a lane; a
    stream resumed after 3 steps still needs 2 (its 4 committed tokens are
    part of max_new), so the revoked run completes on a pool of
    ``B * 2 + 1`` pages and max_context 32, and equals the uninterrupted
    run."""
    model, params, prompts, _ = f32
    new = 32 - S
    whole = serve.serve_plan(model, params, prompts, new, [8], engine=True, device="cpu")
    cut = serve.serve_plan(model, params, prompts, new, [8, 4], revoke_after=REVOKE,
                           engine=True, device="cpu")
    assert cut["tokens"] == whole["tokens"] and len(cut["tokens"][0]) == new


# --- drain, cache policy, flags, traces ---------------------------------------------

def test_drain_replica_moves_every_stream(f32):
    """Two lanes and four requests: two streams in flight and two queued;
    every one moves, one Drain is emitted, the dying pool is empty, and
    the drained streams complete as uninterrupted serving does."""
    model, params, prompts, _ = f32
    kw = dict(lanes=2, num_pages=2 * 2 + 1, max_context=S + NEW)

    def reqs():
        return [Request(rid=b, prompt=prompts[b], max_new_tokens=NEW) for b in range(B)]

    whole = DecodeEngine(model, ShardingLayout(), "cpu", **kw)
    for r in reqs():
        whole.submit(r)
    want = {c.rid: c.tokens for c in whole.run(params)}

    src = DecodeEngine(model, ShardingLayout(), "cpu", **kw)
    dst = DecodeEngine(model, ShardingLayout(), "cpu", **kw)
    for r in reqs():
        src.submit(r)
    for _ in range(3):
        src.step(params)
    assert src.in_flight == B and src.free_pages < src.num_pages - 1
    with recording() as rec:
        moved = drain_replica(src, dst)
    drains = [e for e in rec.events if isinstance(e, E.Drain)]
    assert moved == B and len(drains) == 1 and drains[0].moved_requests == B
    assert sum(isinstance(e, E.Shed) for e in rec.events) == 2
    assert src.in_flight == 0 and src.free_pages == src.num_pages - 1
    assert not src.completions and dst.in_flight == B
    src.release_pool()
    assert src.cache is None
    assert {c.rid: c.tokens for c in dst.run(params)} == want


def test_migrate_cache_copies_and_drop_drops():
    model = build_model(get_arch("qwen3-4b").reduced())
    cache = model.init_cache(2, 32, "cpu")
    man = ElasticMeshManager([torch.device("cpu")] * 8)
    sh = cache_shardings(model.cache_specs(2, 32), man.plan_for(4).mesh, ShardingLayout())
    assert migrate_cache(cache, sh, "drop") is None
    moved = migrate_cache(cache, sh, "migrate")
    for key in ("k", "v", "pos_ids"):
        a, b = cache["blocks"][key], moved["blocks"][key]
        assert torch.equal(a, b) and a.data_ptr() != b.data_ptr()
    cache["blocks"]["k"].fill_(1.0)
    assert not torch.equal(cache["blocks"]["k"], moved["blocks"]["k"])


@pytest.mark.parametrize("argv,exc", [
    (["--engine"], SystemExit),
    (["--engine", "--plan", "8,4", "--revoke-after", "3", "--cache-policy", "migrate"],
     SystemExit),
    (["--int8-cache"], NotImplementedError),
    (["--int8-cache", "--plan", "8"], NotImplementedError),
], ids=["engine-without-plan", "engine-migrate", "int8", "int8-plan"])
def test_flag_rules_raise_as_in_the_reference(argv, exc):
    with pytest.raises(exc):
        serve.main(BASE + argv)


@pytest.mark.parametrize("mode", [[], ["--plan", "8,4", "--revoke-after", "3"],
                                  ["--plan", "8,4", "--revoke-after", "3", "--engine"]],
                         ids=["host", "plan", "engine"])
def test_trace_written_in_every_mode(mode, tmp_path):
    path = tmp_path / "serve.jsonl"
    serve.main(BASE + mode + ["--trace", str(path)])
    events = read_jsonl(path)
    kinds = {type(e).__name__ for e in events}
    if "--engine" in mode:
        assert {"Admit", "Shed", "Drain", "Evict"} <= kinds
        assert sum(isinstance(e, E.Admit) for e in events) == 2 * B
    else:
        assert events == []
    assert replay.main([str(path)]) == 0
