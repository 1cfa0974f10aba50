"""The port's training path against the JAX package's, on the CPU.

``qwen3-4b`` reduced at f32, JAX params from ``init_train_state(model,
jax.random.key(0))`` carried across by ``train_state_from_jax``; the same
``SyntheticLM`` batches go into both. Tolerances: f32 rtol 1e-4 on loss
and grad norm and atol 1e-5 on params (XLA and torch sum in different
orders); bf16 gradients (``gradient_allreduce_dtype="bfloat16"``) 2e-2,
since the two stacks round to bf16 at different places.
"""
import dataclasses
import os
from pathlib import Path
import subprocess
import sys
import threading

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.ckpt import CheckpointManager as JaxCheckpointManager
from repro.config import ShardingLayout as JaxLayout
from repro.config import TrainConfig as JaxTrainConfig
from repro.config import get_arch as jax_get_arch
from repro.data import SyntheticLM as JaxSyntheticLM
from repro.models import build_model as jax_build_model
from repro.models.transformer import RunOpts as JaxRunOpts
from repro.optim import OptState as JaxOptState
from repro.optim import adamw_update as jax_adamw
from repro.optim import clip_by_global_norm as jax_clip
from repro.optim.schedule import linear as jax_linear
from repro.optim.schedule import warmup_cosine as jax_warmup_cosine
from repro.train import steps as jax_steps
from repro_torch.ckpt import CheckpointManager
from repro_torch.config import ShardingLayout, TrainConfig, get_arch
from repro_torch.data import SyntheticLM
from repro_torch.models import RunOpts, build_model
from repro_torch.models.common import tree_leaves, tree_map
from repro_torch.models.convert import (
    params_from_jax,
    params_to_numpy,
    train_state_from_jax,
    train_state_to_numpy,
)
from repro_torch.optim import OptState, adamw_update, clip_by_global_norm
from repro_torch.optim.schedule import linear, warmup_cosine
from repro_torch.train import steps
from repro_torch.train.loop import Revoked, run_segment

REPO = Path(__file__).resolve().parents[1]
F32_TOL = dict(rtol=1e-4)
PARAM_ATOL = 1e-5
BF16_TOL = dict(rtol=2e-2, atol=2e-2)
# the JAX step's f32 losses on this setup (seq 32, batch 4, warmup 2)
JAX_LOSSES = [6.0902, 5.9734, 5.8894]


def _cfgs():
    return (dataclasses.replace(jax_get_arch("qwen3-4b").reduced(), dtype="float32"),
            dataclasses.replace(get_arch("qwen3-4b").reduced(), dtype="float32"))


@pytest.fixture(scope="module")
def jax_state():
    jcfg, _ = _cfgs()
    state = jax_steps.init_train_state(jax_build_model(jcfg), jax.random.key(0))
    return jax.tree_util.tree_map(np.asarray, state)


def _np(x):
    return x.detach().float().numpy() if isinstance(x, torch.Tensor) else np.asarray(x, np.float32)


def _tensors(tree):
    return tree_map(lambda a: torch.from_numpy(np.array(a, np.float32)), tree)


# ---------------------------------------------------------------------------
# data, schedules, optimizer
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("shard,num_shards", [(0, 1), (1, 2)])
def test_synthetic_lm_batches_bit_identical(shard, num_shards):
    ours = SyntheticLM(256, 48, 4, seed=3, shard=shard, num_shards=num_shards)
    ref = JaxSyntheticLM(256, 48, 4, seed=3, shard=shard, num_shards=num_shards)
    for step in (0, 1, 7):
        a, b = ours.batch(step), ref.batch(step)
        assert a.keys() == b.keys()
        for k in a:
            assert a[k].dtype == b[k].dtype and np.array_equal(a[k], b[k])


@pytest.mark.parametrize("ours,ref", [(warmup_cosine, jax_warmup_cosine), (linear, jax_linear)])
def test_schedules_match_jax(ours, ref):
    tc = TrainConfig(total_steps=12, warmup_steps=3)
    jtc = JaxTrainConfig(total_steps=12, warmup_steps=3)
    for step in range(15):
        want = float(ref(jnp.asarray(step, jnp.int32), jtc))
        assert ours(step, tc) == pytest.approx(want, rel=1e-6, abs=1e-12)


def _opt_tree(seed):
    rng = np.random.RandomState(seed)
    return {"blocks": {"w": rng.randn(3, 8, 5).astype(np.float32),
                       "s": rng.randn(3, 5).astype(np.float32)},
            "embed": rng.randn(16, 8).astype(np.float32)}


@pytest.mark.parametrize("max_norm", [1e3, 0.5])
def test_clip_and_adamw_match_jax(max_norm):
    """Clip (on and off) then one AdamW step at count 3, in place, against
    the reference's functional update."""
    params, grads, m, v = (_opt_tree(s) for s in range(4))
    v = tree_map(np.abs, v)
    tc = TrainConfig(weight_decay=0.1)
    jtc = JaxTrainConfig(weight_decay=0.1)
    jg, jnorm = jax_clip(jax.tree_util.tree_map(jnp.asarray, grads), max_norm)
    jp, jopt = jax_adamw(jg, JaxOptState(m=m, v=v, count=jnp.asarray(3, jnp.int32)),
                         params, 2e-3, jtc)

    tp, tg, tm, tv = (_tensors(t) for t in (params, grads, m, v))
    g2, norm = clip_by_global_norm(tg, max_norm)
    assert g2 is tg
    p2, opt = adamw_update(tg, OptState(m=tm, v=tv, count=3), tp, 2e-3, tc)
    assert opt.count == 4 and p2 is tp and opt.m is tm
    assert float(norm) == pytest.approx(float(jnorm), rel=1e-6)
    for ours, ref in ((tg, jg), (tp, jp), (tm, jopt.m), (tv, jopt.v)):
        for a, b in zip(jax.tree_util.tree_leaves(ours), jax.tree_util.tree_leaves(ref)):
            np.testing.assert_allclose(_np(a), np.asarray(b), rtol=1e-6, atol=1e-7)


# ---------------------------------------------------------------------------
# losses
# ---------------------------------------------------------------------------

def _grads_of(fn, *arrays):
    leaves = [torch.from_numpy(a).requires_grad_() for a in arrays]
    out = fn(*leaves)
    out.backward()
    return float(out.detach()), [t.grad.numpy() for t in leaves]


@pytest.mark.parametrize("label_smoothing", [0.0, 0.1])
def test_cross_entropy_matches_jax(label_smoothing):
    rng = np.random.RandomState(0)
    logits = rng.randn(2, 8, 16).astype(np.float32) * 3
    labels = rng.randint(0, 16, (2, 8)).astype(np.int32)
    jfn = lambda lg: jax_steps.cross_entropy(lg, jnp.asarray(labels), label_smoothing)
    want, jgrad = jax.value_and_grad(jfn)(jnp.asarray(logits))
    got, (grad,) = _grads_of(
        lambda lg: steps.cross_entropy(lg, torch.from_numpy(labels), label_smoothing), logits)
    assert got == pytest.approx(float(want), rel=1e-6)
    np.testing.assert_allclose(grad, np.asarray(jgrad), rtol=1e-5, atol=1e-7)


@pytest.mark.parametrize("S,chunk,label_smoothing", [
    (16, 4, 0.0),      # four chunks
    (16, 4, 0.1),      # label smoothing
    (10, 4, 0.0),      # ragged: one slab
    (6, 256, 0.1),     # chunk longer than the sequence
])
def test_chunked_cross_entropy_matches_jax(S, chunk, label_smoothing):
    rng = np.random.RandomState(S + chunk)
    x = rng.randn(2, S, 8).astype(np.float32)
    w = rng.randn(8, 32).astype(np.float32)
    labels = rng.randint(0, 32, (2, S)).astype(np.int32)
    jfn = lambda x, w: jax_steps.chunked_cross_entropy(x, w, jnp.asarray(labels), chunk,
                                                       label_smoothing)
    want, jgrads = jax.value_and_grad(jfn, argnums=(0, 1))(jnp.asarray(x), jnp.asarray(w))
    got, grads = _grads_of(lambda x, w: steps.chunked_cross_entropy(
        x, w, torch.from_numpy(labels), chunk, label_smoothing), x, w)
    assert got == pytest.approx(float(want), rel=1e-5)
    for g, jg in zip(grads, jgrads):
        np.testing.assert_allclose(g, np.asarray(jg), rtol=1e-4, atol=1e-6)
    # the fused loss equals the plain one over full logits
    plain = steps.cross_entropy(torch.from_numpy(x) @ torch.from_numpy(w),
                                torch.from_numpy(labels), label_smoothing)
    assert got == pytest.approx(float(plain), rel=1e-5)


# ---------------------------------------------------------------------------
# model forward and the train step
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("attn_impl", ["masked", "flash"])
def test_forward_train_matches_jax(jax_state, attn_impl):
    jcfg, cfg = _cfgs()
    tokens = np.random.RandomState(0).randint(0, cfg.vocab_size, (2, 24)).astype(np.int32)
    want, _ = jax_build_model(jcfg).forward(
        jax.tree_util.tree_map(jnp.asarray, jax_state.params), {"tokens": jnp.asarray(tokens)},
        JaxRunOpts(attn_impl=attn_impl))
    model = build_model(cfg)
    params = params_from_jax(jax_state.params, cfg, "cpu")
    for remat in ("full", "none"):
        logits, aux = model.forward(params, {"tokens": torch.from_numpy(tokens)},
                                    RunOpts(attn_impl=attn_impl, remat=remat))
        assert float(aux) == 0.0
        np.testing.assert_allclose(_np(logits), np.asarray(want), rtol=1e-4, atol=1e-4)
    with pytest.raises(NotImplementedError, match="dots"):
        model.forward(params, {"tokens": torch.from_numpy(tokens)}, RunOpts(remat="dots"))


def _run_jax(jax_state, attn_impl, microbatches, compress, n_steps=3):
    jcfg, _ = _cfgs()
    layout = JaxLayout(attn_impl=attn_impl,
                       gradient_allreduce_dtype="bfloat16" if compress else "float32")
    tc = JaxTrainConfig(total_steps=10, warmup_steps=2, microbatches=microbatches)
    step = jax.jit(jax_steps.build_train_step(jax_build_model(jcfg), tc, layout, constrain=None))
    state = jax.tree_util.tree_map(jnp.asarray, jax_state)
    ds = JaxSyntheticLM(256, 32, 4, seed=0)
    metrics = []
    for i in range(n_steps):
        state, m = step(state, {k: jnp.asarray(v) for k, v in ds.batch(i).items()})
        metrics.append({k: float(v) for k, v in m.items()})
    return metrics, jax.tree_util.tree_map(np.asarray, state)


def _run_port(jax_state, attn_impl, microbatches, compress, n_steps=3):
    _, cfg = _cfgs()
    layout = ShardingLayout(attn_impl=attn_impl,
                            gradient_allreduce_dtype="bfloat16" if compress else "float32")
    tc = TrainConfig(total_steps=10, warmup_steps=2, microbatches=microbatches)
    step = steps.build_train_step(build_model(cfg), tc, layout)
    state = train_state_from_jax(jax_state, cfg, "cpu")
    ds = SyntheticLM(256, 32, 4, seed=0)
    metrics = []
    for i in range(n_steps):
        state, m = step(state, {k: torch.from_numpy(v) for k, v in ds.batch(i).items()})
        metrics.append({k: float(v) for k, v in m.items()})
    return metrics, state


@pytest.mark.parametrize("compress", [False, True], ids=["f32-grads", "bf16-grads"])
@pytest.mark.parametrize("microbatches", [1, 2])
@pytest.mark.parametrize("attn_impl", ["masked", "flash"])
def test_train_step_matches_jax(jax_state, attn_impl, microbatches, compress):
    want, jstate = _run_jax(jax_state, attn_impl, microbatches, compress)
    got, state = _run_port(jax_state, attn_impl, microbatches, compress)
    tol = BF16_TOL if compress else F32_TOL
    for g, w in zip(got, want):
        assert g.keys() == w.keys()
        for k in ("loss", "grad_norm", "lr", "aux_loss"):
            np.testing.assert_allclose(g[k], w[k], **tol, err_msg=k)
    if not compress:
        np.testing.assert_allclose([w["loss"] for w in want], JAX_LOSSES, atol=1e-4)
    assert state.step == int(jstate.step) == 3 and state.opt.count == int(jstate.opt.count)
    ours = train_state_to_numpy(state)
    for tree, ref in ((ours.params, jstate.params), (ours.opt.m, jstate.opt.m),
                      (ours.opt.v, jstate.opt.v)):
        for a, b in zip(jax.tree_util.tree_leaves(tree), jax.tree_util.tree_leaves(ref)):
            if compress:
                np.testing.assert_allclose(a, b, **BF16_TOL)
            else:
                np.testing.assert_allclose(a, b, atol=PARAM_ATOL, rtol=0)


def test_train_step_on_cuda_requires_flash():
    """The card's train step never runs the plain attention: a masked
    layout is refused for params on a CUDA device (checked before any
    CUDA work, so a fake device type suffices)."""
    _, cfg = _cfgs()
    step = steps.build_train_step(build_model(cfg), TrainConfig(), ShardingLayout())

    class FakeCuda:
        type = "cuda"

    class Leaf:
        device = FakeCuda()

    with pytest.raises(ValueError, match="flash"):
        step(steps.TrainState({"embed": Leaf()}, None, 0), {})


# ---------------------------------------------------------------------------
# loop, checkpoints, conversion, launcher
# ---------------------------------------------------------------------------

def test_run_segment_loss_decreases_and_revocation_raises():
    """Mirrors tests/test_train_and_data.py's loop test on the port."""
    cfg = get_arch("qwen3-4b").reduced()
    model = build_model(cfg)
    ds = SyntheticLM(cfg.vocab_size, seq_len=32, global_batch=4, seed=0)
    tc = TrainConfig(total_steps=40, warmup_steps=4, learning_rate=1e-3)
    state = steps.init_train_state(model, torch.Generator().manual_seed(0), "cpu")
    res = run_segment(model, state, ds, "cpu", tc, ShardingLayout(), num_steps=30)
    assert res.steps_done == 30 and len(res.losses) == len(res.step_seconds) == 30
    assert np.mean(res.losses[:5]) > np.mean(res.losses[-5:])
    assert res.state.step == 30

    with pytest.raises(Revoked) as e:
        run_segment(model, res.state, ds, "cpu", tc, ShardingLayout(),
                    num_steps=10, start_step=30, revoke_at_step=lambda s: s >= 33)
    assert e.value.last_step == 32


def test_train_state_round_trip_bit_exact(jax_state):
    _, cfg = _cfgs()
    back = train_state_to_numpy(train_state_from_jax(jax_state, cfg, "cpu"))
    a = jax.tree_util.tree_leaves(back)
    b = jax.tree_util.tree_leaves(jax_state)
    assert len(a) == len(b)
    for x, y in zip(a, b):
        assert x.dtype == y.dtype and np.array_equal(x, y)


def _advance(jax_state, cfg):
    """A port state one step in (non-zero moments, count 1, step 1)."""
    state = train_state_from_jax(jax_state, cfg, "cpu")
    step = steps.build_train_step(build_model(cfg), TrainConfig(warmup_steps=0),
                                  ShardingLayout())
    batch = SyntheticLM(256, 16, 2, seed=1).batch(0)
    return step(state, {k: torch.from_numpy(v) for k, v in batch.items()})[0]


def test_checkpoint_port_to_jax_and_back(tmp_path, jax_state):
    _, cfg = _cfgs()
    state = _advance(jax_state, cfg)
    ours = CheckpointManager(str(tmp_path / "port"), keep=2)
    for s in (1, 2, 3):
        ours.save(s, state)
    ours.close()
    assert ours.all_steps() == [2, 3]

    step, restored = JaxCheckpointManager(str(tmp_path / "port")).restore(like=jax_state)
    assert step == 3
    want = train_state_to_numpy(state)
    for a, b in zip(jax.tree_util.tree_leaves(restored), jax.tree_util.tree_leaves(want)):
        assert np.asarray(a).dtype == b.dtype and np.array_equal(np.asarray(a), b)

    # ... and a JAX checkpoint of the same state restores in the port
    jm = JaxCheckpointManager(str(tmp_path / "jax"))
    jm.save(7, restored, block=True)
    jm.close()
    step, back = CheckpointManager(str(tmp_path / "jax")).restore(device="cpu", like=state)
    assert step == 7 and back.step == state.step and back.opt.count == state.opt.count
    for a, b in zip(tree_leaves(back.params) + tree_leaves(back.opt.m),
                    tree_leaves(state.params) + tree_leaves(state.opt.m)):
        assert torch.equal(a, b)


def test_checkpoint_keeps_bf16_leaves(tmp_path):
    tree = {"w": torch.randn(4, 3).to(torch.bfloat16), "n": 5}
    m = CheckpointManager(str(tmp_path))
    m.save(1, tree, block=True)
    m.close()
    _, back = m.restore(device="cpu", like=tree)
    assert back["n"] == 5 and back["w"].dtype == torch.bfloat16
    assert torch.equal(back["w"], tree["w"])
    _, jback = JaxCheckpointManager(str(tmp_path)).restore()
    assert str(jback[1].dtype) == "bfloat16"
    np.testing.assert_array_equal(np.asarray(jback[1], np.float32), tree["w"].float().numpy())


def test_params_to_numpy_after_training_still_converts(jax_state):
    """The trained tree keeps its stacked layout for serving and export."""
    _, cfg = _cfgs()
    state = _advance(jax_state, cfg)
    again = params_from_jax(params_to_numpy(state.params), cfg, "cpu")
    for a, b in zip(tree_leaves(again), tree_leaves(state.params)):
        assert torch.equal(a, b)


def test_train_launcher_runs_on_cpu():
    env = {**os.environ, "PYTHONPATH": str(REPO / "src")}
    res = subprocess.run(
        [sys.executable, "-m", "repro_torch.launch.train", "--device", "cpu", "--steps", "3"],
        capture_output=True, text=True, env=env, timeout=300, cwd=REPO,
    )
    assert res.returncode == 0, res.stderr
    assert '"training done"' in res.stdout


def test_checkpoint_save_copies_cpu_tensors(tmp_path):
    """``save`` snapshots now: a CPU tensor updated in place after ``save``
    (as the train step updates params) does not reach the checkpoint."""
    t = torch.arange(1 << 16, dtype=torch.float32)
    ckpt = CheckpointManager(str(tmp_path), keep=1)
    gate, write = threading.Event(), ckpt._write
    ckpt._write = lambda step, leaves: (gate.wait(), write(step, leaves))
    ckpt.save(1, {"w": t})
    t.add_(1.0)                      # before the writer thread may write
    gate.set()
    ckpt.wait()
    _, restored = ckpt.restore(1, device="cpu", like={"w": t})
    ckpt.close()
    assert torch.equal(restored["w"], torch.arange(1 << 16, dtype=torch.float32))
