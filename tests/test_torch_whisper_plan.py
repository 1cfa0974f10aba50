"""whisper-tiny under the port's ``--plan`` (``repro_torch.launch.serve``)
against the JAX package's ``plan_main``, on the CPU.

An encoder-decoder serves on the dense plans: its encoder's output, the
``memory``, is a leaf of the dense cache, so ``--cache-policy migrate``
moves it with the KV cache and prices its bytes with theirs, and ``drop``
re-runs the encoder over the frames in the re-prefill.

* Reduced whisper-tiny at batch 4, prompt 16, 8 new tokens, revoked after
  3 (plans 8 -> 4): the byte columns and ``migrated_at`` under ``drop`` and
  ``migrate`` equal the reference's ``PLAN_JSON`` from one 8-device
  subprocess (``params_bytes`` 2,085,888, ``cache_bytes`` 0 / 110,592,
  ``train_path_bytes`` 8,340,480), through ``serve_plan`` and the CLI.
* The full-width counts that ``chip_smoke.py``'s whisper_plan phase holds
  its runs to (``whisper_plan_predicted``) equal the reference's placement
  arithmetic on the same specs and plans, the memory's share included.
* At f32, with the reference's weights (biases and norm scales drawn off
  their defaults in both packages) and the same frames, the uninterrupted
  stream equals greedy decoding by the reference's ``Model.prefill`` and
  ``decode_step``, and the revoked streams equal it in full; ``drop`` runs
  the encoder twice, ``migrate`` once, and the migrated memory is a copy.
* ``--engine`` refuses whisper, as the reference's paged cache does.
"""
import dataclasses
import importlib.util
import json
import os
from pathlib import Path
import subprocess
import sys
import textwrap
from unittest import mock

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.config import get_arch as jax_get_arch
from repro.models import build_model as jax_build_model
from repro_torch.config import get_arch
from repro_torch.launch import serve
from repro_torch.models import build_model, transformer
from repro_torch.models.convert import params_from_jax

REPO = Path(__file__).resolve().parents[1]
WHISPER = "whisper-tiny"
B, S, NEW, REVOKE = 4, 16, 8, 3
BASE = ["--arch", WHISPER, "--batch", str(B), "--prompt-len", str(S),
        "--new-tokens", str(NEW), "--device", "cpu"]
BYTE_COLUMNS = ("plans", "params_bytes", "cache_bytes", "train_path_bytes", "migrated_at",
                "cache_policy")
BIASES = ("bias", "bi", "bo", "bq", "bk", "bv")

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

    base = ["--arch", "whisper-tiny", "--batch", "%d", "--prompt-len", "%d",
            "--new-tokens", "%d"]
    res = {p: plan_json(base + ["--plan", "8,4", "--revoke-after", "%d",
                                "--cache-policy", p]) for p in ("drop", "migrate")}
    # the full-width serving state's placements on the same two plans
    model = build_model(get_arch("whisper-tiny"))
    man, layout = ElasticMeshManager(), ShardingLayout()
    old, new = man.plan_for(8).mesh, man.plan_for(4).mesh
    c_specs = model.cache_specs(%d, %d)
    c_old, c_new = cache_shardings(c_specs, old, layout), cache_shardings(c_specs, new, layout)
    mem = lambda tree: {"memory": tree["memory"]}
    res["full_width"] = {
        "params_bytes": reshard_bytes(model.specs, param_shardings(model.specs, old, layout),
                                      param_shardings(model.specs, new, layout)),
        "cache_bytes": reshard_bytes(c_specs, c_old, c_new),
        "train_path_bytes": train_state_bytes(model),
        "memory_bytes": reshard_bytes(mem(c_specs), mem(c_old), mem(c_new)),
    }
    print("REF_JSON " + json.dumps(res))
    """ % (B, S, NEW, REVOKE, 16, 64 + 128)
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


def _drawn(tree, rng):
    """Every bias N(0, 0.5) and norm scale 1 + N(0, 0.2) (``init`` gives
    zeros and ones); the other leaves shared."""
    if not isinstance(tree, dict):
        return tree
    out = {}
    for k, v in tree.items():
        if k in BIASES and not isinstance(v, dict):
            out[k] = (0.5 * rng.randn(*v.shape)).astype(np.float32)
        elif k == "scale" and not isinstance(v, dict):
            out[k] = (1.0 + 0.2 * rng.randn(*v.shape)).astype(np.float32)
        else:
            out[k] = _drawn(v, rng)
    return out


@pytest.fixture(scope="module")
def f32():
    """Reduced f32 whisper in both packages, the same weights and frames,
    and the reference's greedy stream (``Model.prefill`` + ``decode_step``)."""
    jcfg = dataclasses.replace(jax_get_arch(WHISPER).reduced(), dtype="float32")
    cfg = dataclasses.replace(get_arch(WHISPER).reduced(), dtype="float32")
    tree = _drawn(jax.tree_util.tree_map(np.asarray, jax_build_model(jcfg).init(
        jax.random.key(0))), np.random.RandomState(1))
    jm, jp = jax_build_model(jcfg), jax.tree_util.tree_map(jnp.asarray, tree)
    prompts = np.random.RandomState(0).randint(0, cfg.vocab_size, (B, S)).astype(np.int32)
    frames = np.random.RandomState(2).randn(B, cfg.encoder_seq_len,
                                            cfg.d_model).astype(np.float32)
    logits, cache = jax.jit(lambda p, b: jm.prefill(p, b, S + NEW))(
        jp, {"tokens": jnp.asarray(prompts), "frames": jnp.asarray(frames)})
    decode = jax.jit(jm.decode_step)
    tok = jnp.argmax(logits[:, -1], axis=-1).astype(jnp.int32)[:, None]
    toks = [np.asarray(tok)]
    for i in range(NEW - 1):
        logits, cache = decode(jp, cache, tok, jnp.int32(S + i))
        tok = jnp.argmax(logits[:, -1], axis=-1).astype(jnp.int32)[:, None]
        toks.append(np.asarray(tok))
    oracle = np.concatenate(toks, axis=1).tolist()
    return (build_model(cfg), params_from_jax(tree, cfg, "cpu"), prompts,
            torch.from_numpy(frames), oracle)


def _serve(f32, counts, **kw):
    model, params, prompts, frames, _ = f32
    return serve.serve_plan(model, params, prompts, NEW, counts, device="cpu", frames=frames,
                            **kw)


# --- byte columns against the reference's PLAN_JSON -----------------------------

@pytest.mark.parametrize("policy", ["drop", "migrate"])
def test_plan_byte_columns_equal_reference(reference, policy):
    """The tree the reference serves (f32 params, bf16 compute), bf16 frames."""
    jcfg, cfg = jax_get_arch(WHISPER).reduced(), get_arch(WHISPER).reduced()
    jp = jax_build_model(jcfg).init(jax.random.key(0))
    params = params_from_jax(jax.tree_util.tree_map(np.asarray, jp), cfg, "cpu")
    prompts = np.random.RandomState(1).randint(0, cfg.vocab_size, (B, S)).astype(np.int32)
    frames = torch.randn((B, cfg.encoder_seq_len, cfg.d_model),
                         generator=torch.Generator().manual_seed(0)).to(torch.bfloat16)
    out = serve.serve_plan(build_model(cfg), params, prompts, NEW, [8, 4], revoke_after=REVOKE,
                           cache_policy=policy, device="cpu", frames=frames)
    ref = reference[policy]
    assert {k: out[k] for k in BYTE_COLUMNS} == {k: ref[k] for k in BYTE_COLUMNS}
    assert (out["params_bytes"], out["train_path_bytes"]) == (2_085_888, 8_340_480)
    assert out["cache_bytes"] == (110_592 if policy == "migrate" else 0)
    assert set(out["measured_steps_per_sec"]) == set(ref["measured_steps_per_sec"]) == \
        {"4x2", "2x2"}


@pytest.mark.parametrize("policy", ["drop", "migrate"])
def test_cli_plan_byte_columns_equal_reference(reference, policy, capsys):
    out = serve.main(BASE + ["--plan", "8,4", "--revoke-after", str(REVOKE),
                             "--cache-policy", policy])
    lines = capsys.readouterr().out.splitlines()
    printed = json.loads(next(l for l in lines if l.startswith("PLAN_JSON "))[10:])
    assert printed == json.loads(json.dumps(out))
    ref = reference[policy]
    assert {k: out[k] for k in BYTE_COLUMNS} == {k: ref[k] for k in BYTE_COLUMNS}
    assert out["recover_seconds"] > 0 and len(out["tokens"]) == B


def _chip_smoke():
    spec = importlib.util.spec_from_file_location("chip_smoke", REPO / "chip_smoke.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def test_full_width_byte_counts_equal_reference_and_chip_prediction(reference):
    """The full-width counts chip_smoke.py's whisper_plan phase holds its
    runs to equal the reference's placement arithmetic: f32 params, the
    bf16 cache at 16 x 192 positions and its memory's share, the training
    path's state."""
    cs = _chip_smoke()
    assert cs.WHISPER_PLAN["B"] == 16 and cs.WHISPER_PLAN["S"] + cs.WHISPER_PLAN["new"] == 192
    predicted = cs.whisper_plan_predicted(build_model(get_arch(WHISPER)))
    assert {k: predicted[k] for k in reference["full_width"]} == reference["full_width"]
    # the memory leaf is 16 x 1500 x 384 bf16; what moves of it is its share
    assert predicted["memory_size"] == 16 * 1500 * 384 * 2 == 18_432_000
    assert 0 < predicted["memory_bytes"] <= predicted["memory_size"]
    assert predicted["memory_bytes"] < predicted["cache_bytes"]
    assert 0 < predicted["params_bytes"] < predicted["train_path_bytes"]


# --- streams at f32 -------------------------------------------------------------

def _encoder_calls(f32, counts, **kw):
    with mock.patch.object(transformer, "_run_encoder", wraps=transformer._run_encoder) as enc:
        out = _serve(f32, counts, **kw)
    return out, enc.call_count


def test_f32_uninterrupted_stream_equals_reference_greedy(f32):
    out, calls = _encoder_calls(f32, [8])
    assert out["tokens"] == f32[4]
    assert out["migrated_at"] is None and out["recover_seconds"] is None and calls == 1


@pytest.mark.parametrize("policy", ["drop", "migrate"])
def test_f32_revoked_stream_equals_uninterrupted(f32, policy):
    out, calls = _encoder_calls(f32, [8, 4], revoke_after=REVOKE, cache_policy=policy)
    assert out["tokens"] == f32[4]
    assert out["migrated_at"] == REVOKE and out["decode_steps"] == NEW - 1
    # drop re-runs the encoder over the frames in its re-prefill; migrate
    # carries the memory over
    assert calls == (2 if policy == "drop" else 1)
    assert (out["cache_bytes"] > 0) == (policy == "migrate")


def test_migrated_memory_is_a_copy(f32):
    from repro_torch.dist import ElasticMeshManager, cache_shardings
    from repro_torch.serve.migrate import migrate_cache

    model, params, prompts, frames, _ = f32
    _, cache = model.prefill(params, {"tokens": torch.as_tensor(prompts), "frames": frames},
                             S + NEW)
    man = ElasticMeshManager([torch.device("cpu")] * 8)
    sh = cache_shardings(model.cache_specs(B, S + NEW), man.plan_for(4).mesh,
                         serve.PLAN_LAYOUT)
    moved = migrate_cache(cache, sh, "migrate")
    assert torch.equal(moved["memory"], cache["memory"])
    assert moved["memory"].data_ptr() != cache["memory"].data_ptr()


@pytest.mark.parametrize("argv", [["--engine"], ["--engine", "--revoke-after", "3"]],
                         ids=["engine", "engine-revoked"])
def test_engine_refuses_whisper_as_the_reference(argv):
    with pytest.raises(NotImplementedError, match="DENSE"):
        serve.main(BASE + ["--plan", "8,4"] + argv)
