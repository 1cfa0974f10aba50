"""The sLSTM at a d that 32 does not divide, on the CPU.

The kernels take d in multiples of 32 (``kernels/slstm/kernel.py``'s
PAD), so the wrapper pads each of the four gate blocks of wx and r, r's
rows and the start state with zero units and slices the padding off what
comes back (``padded_call``, ``padded_bwd_call``). Here the same two calls
wrap the plain versions ``slstm_ref`` and ``slstm_bwd_ref``:

* pad then unpad gives back every tensor bit for bit, the padding zeros;
* a padded unit's h, c (and so hs) and every gradient that reaches it (its
  gate columns of dwx, its rows and columns of dr, its start state's
  gradient) are exactly 0, so it feeds nothing into the real units;
* the real units equal the unpadded call's. The padded call sums the same
  real terms plus exact zeros, but the CPU's BLAS groups a product's terms
  by its contracted length, so in f32 the two differ in the last bits (up
  to 6e-6 at d 200): the hold is in f64 at atol 1e-12;

at d 1, 7 and 200, with and without a start state. Then reduced
xlstm-350m laid out as ``BlockKind.SLSTM`` at d 200 (its sLSTM blocks at
that d, f32) against the JAX package's prefill and 8 decode steps at
atol = rtol = 1e-4, the greedy streams identical. Inputs from numpy
seeds; the model's weights from the reference's init.
"""
import dataclasses
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.config import get_arch as jax_get_arch
from repro.config.base import BlockKind as JaxBlockKind
from repro.models import build_model as jax_build_model
from repro_torch.config import BlockKind, get_arch
from repro_torch.kernels.slstm import kernel
from repro_torch.kernels.slstm.ref import slstm_bwd_ref, slstm_ref
from repro_torch.models import build_model
from repro_torch.models.convert import params_from_jax

B, S = 3, 9
WIDTHS = (1, 7, 200)
TOL = dict(atol=1e-4, rtol=1e-4)


def _inputs(d, with_state, dtype, seed):
    rng = np.random.default_rng(seed)
    t = lambda *shape: torch.tensor(rng.standard_normal(shape), dtype=dtype)
    wx, r = t(B, S, 4 * d), t(d, 4 * d) * (0.5 / np.sqrt(d))
    state = (t(B, d), t(B, d).abs(), 0.5 * t(B, d), 0.5 * t(B, d)) if with_state else None
    return wx, r, state, t(B, S, d), tuple(t(B, d) for _ in range(4))


def _flat(out):
    return [x for y in out if y is not None for x in (y if isinstance(y, tuple) else (y,))]


@pytest.mark.parametrize("d", WIDTHS)
def test_pad_and_unpad_round_trip(d):
    dp = kernel.padded(d)
    wx, r, state, dhs, _ = _inputs(d, True, torch.float32, d)
    assert dp % kernel.PAD == 0 and dp - d < kernel.PAD
    for t, rows, blocks in ((wx, False, 4), (r, True, 4), (state[0], False, 1), (dhs, False, 1)):
        p = kernel.pad_units(t, d, dp, rows=rows)
        assert p.shape[-1] == blocks * dp and (not rows or p.shape[0] == dp)
        assert torch.equal(kernel.unpad_units(p, d, dp, rows=rows), t)
        gates = p.reshape(*p.shape[:-1], blocks, dp)
        assert not gates[..., d:].any() and (not rows or not p[d:].any())


@pytest.mark.parametrize("with_state", [False, True], ids=["zero-state", "with-state"])
@pytest.mark.parametrize("d", WIDTHS)
def test_padded_units_feed_nothing(d, with_state):
    """The plain versions at the padded width: a padded unit's hs, c and h,
    and every gradient of it, exactly 0."""
    dp = kernel.padded(d)
    wx, r, state, dhs, dfin = _inputs(d, with_state, torch.float32, 10 + d)
    pad = lambda t: kernel.pad_units(t, d, dp)
    pstate = None if state is None else tuple(map(pad, state))
    hs, (c, n, h, m), kept = slstm_ref(pad(wx), kernel.pad_units(r, d, dp, rows=True), pstate,
                                       keep=True)
    for t in (hs, c, h):
        assert not t[..., d:].any()
    dwx, dr, d0 = slstm_bwd_ref(kernel.pad_units(r, d, dp, rows=True), pstate, hs, kept,
                                pad(dhs), tuple(map(pad, dfin)) if with_state else None)
    assert not dwx.reshape(B, S, 4, dp)[..., d:].any()
    assert not dr[d:].any() and not dr.reshape(dp, 4, dp)[..., d:].any()
    for t in d0 or ():
        assert not t[:, d:].any()


@pytest.mark.parametrize("with_state", [False, True], ids=["zero-state", "with-state"])
@pytest.mark.parametrize("d", WIDTHS)
def test_padded_calls_match_the_unpadded_plain_versions(d, with_state):
    wx, r, state, dhs, dfin = _inputs(d, with_state, torch.float64, 20 + d)
    want = slstm_ref(wx, r, state, keep=True)
    got = kernel.padded_call(slstm_ref, wx, r, state, keep=True)
    for a, b in zip(_flat(got), _flat(want)):
        assert a.shape == b.shape
        torch.testing.assert_close(a, b, atol=1e-12, rtol=0)
    dfin = dfin if with_state else None
    want = slstm_bwd_ref(r, state, want[0], want[2], dhs, dfin)
    got = kernel.padded_bwd_call(slstm_bwd_ref, r, state, got[0], got[2], dhs, dfin)
    assert (got[2] is None) == (state is None)
    for a, b in zip(_flat(got), _flat(want)):
        assert a.shape == b.shape
        torch.testing.assert_close(a, b, atol=1e-12, rtol=0)


# reduced xlstm-350m as BlockKind.SLSTM at d 200 (4 heads: the mLSTM's head dim 100)
WIDE = dict(d_model=200, num_heads=4, num_kv_heads=4, head_dim=0, dtype="float32")
PB, PS, NEW = 2, 12, 8


@functools.lru_cache(maxsize=None)
def _streams():
    jcfg = dataclasses.replace(jax_get_arch("xlstm-350m").reduced(), block=JaxBlockKind("slstm"),
                               **WIDE)
    cfg = dataclasses.replace(get_arch("xlstm-350m").reduced(), block=BlockKind.SLSTM, **WIDE)
    prompt = np.random.RandomState(3).randint(0, cfg.vocab_size, (PB, PS)).astype(np.int32)
    jm = jax_build_model(jcfg)
    jp = jm.init(jax.random.key(0))
    logits, cache = jax.jit(lambda p, b: jm.prefill(p, b, PS + NEW))(
        jp, {"tokens": jnp.asarray(prompt)})
    decode = jax.jit(jm.decode_step)
    jtoks, jouts = [], []
    for i in range(NEW):
        jouts.append(np.asarray(logits[:, -1], np.float32))
        tok = jnp.argmax(logits[:, -1], axis=-1).astype(jnp.int32)[:, None]
        jtoks.append(np.asarray(tok))
        if i + 1 < NEW:
            logits, cache = decode(jp, cache, tok, jnp.int32(PS + i))
    model = build_model(cfg)
    params = params_from_jax(jax.tree_util.tree_map(np.asarray, jp), cfg, "cpu")
    logits, cache = model.prefill(params, {"tokens": torch.as_tensor(prompt)}, PS + NEW)
    toks, outs = [], []
    for i in range(NEW):
        outs.append(logits[:, -1].float().numpy())
        tok = logits[:, -1].argmax(-1).to(torch.int32)[:, None]
        toks.append(tok.numpy())
        if i + 1 < NEW:
            logits, cache = model.decode_step(params, cache, tok, PS + i)
    return (np.concatenate(jtoks, 1), jouts), (np.concatenate(toks, 1), outs), cache


def test_slstm_model_at_an_unaligned_d_matches_jax():
    (jt, jl), (tt, tl), cache = _streams()
    assert cache["groups"]["slstm"]["c"].shape[-1] == 200
    for i, (a, b) in enumerate(zip(tl, jl)):
        np.testing.assert_allclose(a, b, err_msg=f"step {i}", **TOL)
    np.testing.assert_array_equal(tt, jt)
