"""``remat="dots"`` in the port against the JAX package's
``jax.checkpoint_policies.checkpoint_dots_with_no_batch_dims``, on the CPU.

* Three training steps of reduced f32 qwen3-4b, xlstm-350m and hymba-1.5b
  (batch 4 in 2 microbatches, seq 24) under ``ShardingLayout(remat="dots")``
  against ``jax.jit(build_train_step(..., constrain=None))`` under the same
  layout: loss and grad norm rtol 1e-4 at every step, params atol 1e-5 (an
  element whose gradient stayed at rounding level is held by its first
  moments near 0, as ``tests/test_torch_xlstm_train.py`` holds it).
* The port's ``dots`` gradients equal its ``full`` gradients bit for bit.
* A dispatch count pins that ``dots`` is neither ``full`` nor ``none`` under
  another name: its backward runs as many ``aten.mm`` as ``none`` (the
  projections are kept) and fewer than ``full``, and every other op as
  often as ``full`` (the rest is recomputed), so more ops than ``none``.
  The kernels' autograd Functions recompute their forwards under ``dots``
  too: on the CPU their plain versions' products (xlstm's sLSTM and
  mLSTM) are the only ``mm`` that ``dots`` reruns.

Weights from the reference's ``Model.init(jax.random.key(0))`` (xlstm's
gate biases and norm scales redrawn off their defaults in both packages),
carried across by ``train_state_from_jax``; data from ``SyntheticLM`` in
both packages.
"""
import dataclasses
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from torch.utils._python_dispatch import TorchDispatchMode

from repro.config import ShardingLayout as JaxLayout
from repro.config import TrainConfig as JaxTrainConfig
from repro.config import get_arch as jax_get_arch
from repro.data import SyntheticLM as JaxSyntheticLM
from repro.models import build_model as jax_build_model
from repro.train import steps as jax_steps
from repro_torch.config import ShardingLayout, TrainConfig, get_arch
from repro_torch.data import SyntheticLM
from repro_torch.models import RunOpts, build_model, common
from repro_torch.models.convert import params_from_jax, train_state_from_jax, train_state_to_numpy
from repro_torch.models.transformer import per_layer
from repro_torch.train import steps

ARCHS = ("qwen3-4b", "xlstm-350m", "hymba-1.5b")
B, S, N_STEPS = 4, 24, 3
# an element whose second moment stays under NOISE_V on both sides had only
# rounding noise for a gradient; its first moment must stay under NOISE_M
NOISE_V, NOISE_M = 1e-18, 1e-8
MM = "aten.mm.default"


def _cfgs(arch):
    return (dataclasses.replace(jax_get_arch(arch).reduced(), dtype="float32"),
            dataclasses.replace(get_arch(arch).reduced(), dtype="float32"))


def _spread(tree, rng):
    """xlstm's gate biases N(0, 0.5) and norm scales 1 + N(0, 0.2) (``init``
    gives zeros and ones); the other leaves shared."""
    if not isinstance(tree, dict):
        return tree
    out = {}
    for k, v in tree.items():
        if k in ("b_if", "b_gates"):
            out[k] = (0.5 * rng.randn(*v.shape)).astype(np.float32)
        elif k == "scale":
            out[k] = (1.0 + 0.2 * rng.randn(*v.shape)).astype(np.float32)
        else:
            out[k] = _spread(v, rng)
    return out


@functools.lru_cache(maxsize=None)
def _jax_state(arch):
    jcfg, _ = _cfgs(arch)
    state = jax.tree_util.tree_map(
        np.asarray, jax_steps.init_train_state(jax_build_model(jcfg), jax.random.key(0)))
    if arch == "xlstm-350m":
        state = state._replace(params=_spread(state.params, np.random.RandomState(1)))
    return state


def _port_run(arch, remat):
    _, cfg = _cfgs(arch)
    tc = TrainConfig(total_steps=10, warmup_steps=2, microbatches=2)
    step = steps.build_train_step(build_model(cfg), tc,
                                  ShardingLayout(attn_impl="flash", q_chunk=8, kv_chunk=8,
                                                 remat=remat))
    ds = SyntheticLM(cfg.vocab_size, S, B, seed=0)
    state = train_state_from_jax(_jax_state(arch), cfg, "cpu")
    metrics = []
    for i in range(N_STEPS):
        state, m = step(state, {k: torch.from_numpy(v) for k, v in ds.batch(i).items()})
        metrics.append({k: float(v) for k, v in m.items()})
    return metrics, state


@pytest.mark.parametrize("arch", ARCHS)
def test_dots_train_steps_match_jax_dots(arch):
    jcfg, cfg = _cfgs(arch)
    jtc = JaxTrainConfig(total_steps=10, warmup_steps=2, microbatches=2)
    jstep = jax.jit(jax_steps.build_train_step(
        jax_build_model(jcfg), jtc, JaxLayout(q_chunk=8, kv_chunk=8, remat="dots"),
        constrain=None))
    jds = JaxSyntheticLM(cfg.vocab_size, S, B, seed=0)
    jstate = jax.tree_util.tree_map(jnp.asarray, _jax_state(arch))
    want = []
    for i in range(N_STEPS):
        jstate, jm = jstep(jstate, {k: jnp.asarray(v) for k, v in jds.batch(i).items()})
        want.append({k: float(v) for k, v in jm.items()})
    got, state = _port_run(arch, "dots")
    for i, (g, w) in enumerate(zip(got, want)):
        for k in ("loss", "grad_norm"):
            np.testing.assert_allclose(g[k], w[k], rtol=1e-4, err_msg=f"{k} {i}")
    ours, ref = train_state_to_numpy(state), jax.tree_util.tree_map(np.asarray, jstate)
    leaves = jax.tree_util.tree_leaves
    for (path, want_p), p, m, want_m, v, want_v in zip(
            jax.tree_util.tree_leaves_with_path(ref.params), leaves(ours.params),
            leaves(ours.opt.m), leaves(ref.opt.m), leaves(ours.opt.v), leaves(ref.opt.v)):
        top = np.maximum(v, want_v)
        noise = (top > 0) & (top < NOISE_V)
        assert noise.mean() < 0.01, (path, noise.sum())
        assert np.all(np.abs(m[noise]) < NOISE_M) and np.all(np.abs(want_m[noise]) < NOISE_M)
        np.testing.assert_allclose(p[~noise], want_p[~noise], atol=1e-5, rtol=0,
                                   err_msg=str(path))


class _Count(TorchDispatchMode):
    """Counts every aten op by name; ``no_grad_mm`` counts the ``mm`` run
    with grad mode off (inside an autograd Function's forward)."""

    def __init__(self):
        super().__init__()
        self.ops, self.no_grad_mm = {}, 0

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        name = str(func)
        self.ops[name] = self.ops.get(name, 0) + 1
        if name == MM and not torch.is_grad_enabled():
            self.no_grad_mm += 1
        return func(*args, **(kwargs or {}))


@functools.lru_cache(maxsize=None)
def _backward(arch, remat):
    """One microbatch's loss and backward through the train step's pieces
    (per-layer leaves, ``forward_hidden``, the chunked CE): (loss, the
    leaves' grads, the forward's op counts, the backward's)."""
    _, cfg = _cfgs(arch)
    model = build_model(cfg)
    params = params_from_jax(_jax_state(arch).params, cfg, "cpu")
    batch = {k: torch.from_numpy(v) for k, v in SyntheticLM(cfg.vocab_size, S, 2, seed=0)
             .batch(0).items()}
    leaves = per_layer(params, cfg.num_layers, lambda t: t.detach().requires_grad_())
    opts = RunOpts(attn_impl="flash", q_chunk=8, kv_chunk=8, remat=remat)
    with _Count() as fwd:
        x, aux = model.forward_hidden(leaves, batch, opts)
        loss = steps.chunked_cross_entropy(x, model.unembed_weight(leaves), batch["labels"])
    with _Count() as bwd:
        (loss + aux).backward()
    grads = [t.grad.clone() for t in common.tree_flatten(leaves)[0]]
    return float(loss.detach()), grads, fwd, bwd


@pytest.mark.parametrize("arch", ARCHS)
def test_dots_grads_equal_full_grads_bit_for_bit(arch):
    loss_f, full, _, _ = _backward(arch, "full")
    loss_d, dots, _, _ = _backward(arch, "dots")
    assert loss_d == loss_f and len(dots) == len(full)
    assert all(torch.equal(a, b) for a, b in zip(dots, full))


@pytest.mark.parametrize("arch", ARCHS)
def test_dots_keeps_the_products_and_recomputes_the_rest(arch):
    _, _, fwd, none = _backward(arch, "none")
    _, _, _, full = _backward(arch, "full")
    _, _, _, dots = _backward(arch, "dots")
    # the products the kernels' autograd Functions run inside their
    # forwards (the plain versions on the CPU) are recomputed, not kept
    inside = fwd.no_grad_mm
    assert (inside > 0) == (arch == "xlstm-350m")
    assert dots.ops[MM] == none.ops[MM] + inside < full.ops[MM]
    rest = lambda c: {k: v for k, v in c.ops.items() if k != MM}
    assert rest(dots) == rest(full)
    assert sum(rest(dots).values()) > sum(rest(none).values())


def test_unknown_remat_refuses():
    _, cfg = _cfgs("qwen3-4b")
    model = build_model(cfg)
    params = model.init(torch.Generator().manual_seed(0), "cpu")
    with pytest.raises(NotImplementedError, match="remat 'offload'"):
        model.forward(params, {"tokens": torch.zeros((1, 4), dtype=torch.int32)},
                      RunOpts(remat="offload"))
