"""``BlockKind.SLSTM`` in the port against the JAX package, on the CPU.

The reference lays an SLSTM model out exactly as an MLSTM one (groups of
mLSTM blocks, each closed by an sLSTM block: specs, cache specs,
``forward_hidden``, ``prefill`` and ``decode_step`` test both kinds alike).
No config in either package uses the kind, so reduced xlstm-350m with
``block=SLSTM`` (``dataclasses.replace`` in both packages) stands in:

* its specs and cache specs equal the reference's and the MLSTM layout's;
* f32 prefill logits and every state leaf at atol=rtol=1e-4, and identical
  16-token greedy streams through ``decode_step``;
* three training steps (batch 4 in 2 microbatches, seq 24) against
  ``jax.jit(build_train_step(..., constrain=None))``: loss and grad norm
  rtol 1e-4, params atol 1e-5 (an element whose gradient stayed at
  rounding level is held by its first moments near 0).

Weights from the reference's ``Model.init(jax.random.key(0))`` with the
gate biases and norm scales drawn off their defaults, carried across by
``params_from_jax``; prompts made with numpy from a seed.
"""
import dataclasses
import functools

import jax
import jax.numpy as jnp
import numpy as np
import torch

from repro.config import ShardingLayout as JaxLayout
from repro.config import TrainConfig as JaxTrainConfig
from repro.config import get_arch as jax_get_arch
from repro.config.base import BlockKind as JaxBlockKind
from repro.data import SyntheticLM as JaxSyntheticLM
from repro.models import build_model as jax_build_model
from repro.models import transformer as jax_transformer
from repro.train import steps as jax_steps
from repro_torch.config import AttentionKind, BlockKind, ShardingLayout, TrainConfig, get_arch
from repro_torch.data import SyntheticLM
from repro_torch.models import build_model, transformer
from repro_torch.models.convert import (
    cache_to_numpy,
    params_from_jax,
    train_state_from_jax,
    train_state_to_numpy,
)
from repro_torch.train import steps

XLSTM = "xlstm-350m"
B, S, NEW = 2, 16, 16
TOL = dict(atol=1e-4, rtol=1e-4)
NOISE_V, NOISE_M = 1e-18, 1e-8


def _cfgs(block="slstm"):
    return (dataclasses.replace(jax_get_arch(XLSTM).reduced(), dtype="float32",
                                block=JaxBlockKind(block)),
            dataclasses.replace(get_arch(XLSTM).reduced(), dtype="float32",
                                block=BlockKind(block)))


def _spec_fields(tree):
    if isinstance(tree, dict):
        return {k: _spec_fields(v) for k, v in tree.items()}
    return (tuple(tree.shape), tuple(tree.axes), tree.init, tree.scale, tree.dtype)


def _spread(tree, rng):
    """Gate biases N(0, 0.5), norm scales 1 + N(0, 0.2); the rest shared."""
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
def _jax_state():
    jcfg, _ = _cfgs()
    state = jax.tree_util.tree_map(
        np.asarray, jax_steps.init_train_state(jax_build_model(jcfg), jax.random.key(0)))
    return state._replace(params=_spread(state.params, np.random.RandomState(1)))


def _at(tree, path):
    return functools.reduce(lambda t, k: t[k.key], path, tree)


def test_specs_equal_the_reference_and_the_mlstm_layout():
    jcfg, cfg = _cfgs()
    _, mcfg = _cfgs("mlstm")
    assert (cfg.block, cfg.attention) == (BlockKind.SLSTM, AttentionKind.NONE)
    ours = _spec_fields(build_model(cfg).specs)
    assert ours == _spec_fields(jax_build_model(jcfg).specs) == \
        _spec_fields(build_model(mcfg).specs)
    for batch, seq in ((2, 36), (8, 4128)):
        assert (_spec_fields(transformer.cache_specs(cfg, batch, seq))
                == _spec_fields(jax_transformer.cache_specs(jcfg, batch, seq))
                == _spec_fields(transformer.cache_specs(mcfg, batch, seq)))


@functools.lru_cache(maxsize=None)
def _greedy():
    """(JAX, port): each (tokens (B, NEW), per-step logits, prefill cache)."""
    jcfg, cfg = _cfgs()
    prompt = np.random.RandomState(0).randint(0, cfg.vocab_size, (B, S)).astype(np.int32)
    jm = jax_build_model(jcfg)
    jp = jax.tree_util.tree_map(jnp.asarray, _jax_state().params)
    logits, cache = jax.jit(lambda p, b: jm.prefill(p, b, S + NEW))(
        jp, {"tokens": jnp.asarray(prompt)})
    jcache = jax.tree_util.tree_map(lambda a: np.asarray(a, np.float32), cache)
    decode = jax.jit(jm.decode_step)
    jtoks, jouts = [], []
    for i in range(NEW):
        jouts.append(np.asarray(logits[:, -1], np.float32))
        tok = jnp.argmax(logits[:, -1], axis=-1).astype(jnp.int32)[:, None]
        jtoks.append(np.asarray(tok))
        if i + 1 < NEW:
            logits, cache = decode(jp, cache, tok, jnp.int32(S + i))
    model = build_model(cfg)
    params = params_from_jax(_jax_state().params, cfg, "cpu")
    logits, cache = model.prefill(params, {"tokens": torch.as_tensor(prompt)}, S + NEW)
    tcache = cache_to_numpy(cache)
    toks, outs = [], []
    for i in range(NEW):
        outs.append(logits[:, -1].float().numpy())
        tok = logits[:, -1].argmax(-1).to(torch.int32)[:, None]
        toks.append(tok.numpy())
        if i + 1 < NEW:
            logits, cache = model.decode_step(params, cache, tok, S + i)
    return ((np.concatenate(jtoks, axis=1), jouts, jcache),
            (np.concatenate(toks, axis=1), outs, tcache))


def test_prefill_logits_and_states_match_jax():
    (_, jl, jc), (_, tl, tc) = _greedy()
    np.testing.assert_allclose(tl[0], jl[0], **TOL)
    flat = jax.tree_util.tree_leaves_with_path(jc)
    assert set(tc["groups"]) == {"mlstm", "slstm"}
    assert len(flat) == len(jax.tree_util.tree_leaves(tc)) == 7
    for path, a in flat:
        b = _at(tc, path)
        assert b.shape == a.shape, path
        np.testing.assert_allclose(b, a, err_msg=str(path), **TOL)


def test_greedy_stream_matches_jax():
    (jt, jl, _), (tt, tl, _) = _greedy()
    for i, (a, b) in enumerate(zip(tl, jl)):
        np.testing.assert_allclose(a, b, err_msg=f"step {i}", **TOL)
    np.testing.assert_array_equal(tt, jt)


def test_train_steps_match_jax():
    jcfg, cfg = _cfgs()
    jtc = JaxTrainConfig(total_steps=10, warmup_steps=2, microbatches=2)
    jstep = jax.jit(jax_steps.build_train_step(jax_build_model(jcfg), jtc, JaxLayout(),
                                               constrain=None))
    tc = TrainConfig(total_steps=10, warmup_steps=2, microbatches=2)
    step = steps.build_train_step(build_model(cfg), tc, ShardingLayout(attn_impl="flash"))
    jds, ds = JaxSyntheticLM(256, 24, 4, seed=0), SyntheticLM(256, 24, 4, seed=0)
    jstate = jax.tree_util.tree_map(jnp.asarray, _jax_state())
    state = train_state_from_jax(_jax_state(), cfg, "cpu")
    for i in range(3):
        jstate, jm = jstep(jstate, {k: jnp.asarray(v) for k, v in jds.batch(i).items()})
        state, m = step(state, {k: torch.from_numpy(v) for k, v in ds.batch(i).items()})
        for k in ("loss", "grad_norm"):
            np.testing.assert_allclose(float(m[k]), float(jm[k]), rtol=1e-4, err_msg=f"{k} {i}")
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
    start = _jax_state().params["groups"]
    for blk in ("mlstm", "slstm"):
        for key, val in start[blk]["block"].items():
            assert float(np.abs(ours.params["groups"][blk]["block"][key] - val).max()) > 0, key
