"""The port's sLSTM recurrence and its gradient against the JAX package's,
on the CPU.

``slstm_bwd_ref``, the hand-written reverse recurrence (the CUDA backward
kernel's plain version, and what the sLSTM's autograd Function runs on the
CPU), is held against ``jax.grad`` of the reference's ``slstm_block``
(``repro.models.xlstm``) for x, every leaf and the start state, with and
without a start state, at S below 64 (the reference's one-chunk scan) and at
64 (its chunks of 64); and against torch autograd through ``slstm_ref`` in
f64, with ties ``f~ + m == i~`` forced and at the first step from a zero
state, where ``n == 1`` exactly (``torch.clamp`` passes the whole gradient
there and ``jnp.maximum`` half; ``n`` is locally constant, so no gradient
may see it: the JAX comparison shows that it does not). Inputs are made
with numpy from a seed at the reduced width (d = 128). Tolerances: against
JAX the block-gradient tolerance of ``test_torch_xlstm_train.py`` (atol =
rtol = 1e-4, atol at least 1e-5 of the leaf's largest gradient: XLA and
torch sum the products in other orders); against autograd in f64, 1e-10
relative (the same arithmetic in another order).
"""
import dataclasses
import types

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch.nn.functional as F

from repro.config import get_arch as jax_get_arch
from repro.models import xlstm as jax_xlstm
from repro_torch.kernels.slstm import kernel, ops, slstm, slstm_bwd_ref, slstm_ref

XLSTM = "xlstm-350m"
GRAD_TOL = dict(atol=1e-4, rtol=1e-4)
LEAF_ATOL_SCALE = 1e-5
F64_TOL = dict(atol=1e-10, rtol=1e-10)
STATE = ("c", "n", "h", "m")


def _jcfg():
    return dataclasses.replace(jax_get_arch(XLSTM).reduced(), dtype="float32")


def _block_inputs(B, S, d, seed, with_state):
    """The block's params (w_gates fan-in scaled, r_gates at half that,
    b_gates N(0, 0.5), the GEGLU projections fan-in scaled), x, the output's
    weights w, a start state (c, n normal, h 0.5 x normal, m 0.5 x normal)
    and the final state's weights, as f32 numpy arrays."""
    rng = np.random.RandomState(seed)
    f = lambda *shape: rng.randn(*shape).astype(np.float32)
    s = 1.0 / d ** 0.5
    p = {"w_gates": s * f(d, 4 * d), "r_gates": 0.5 * s * f(d, 4 * d),
         "b_gates": 0.5 * f(4 * d), "up_proj": s * f(d, 2 * d), "down_proj": s * f(d, d)}
    a = dict(p=p, x=f(B, S, d), w=f(B, S, d), dfin={k: f(B, d) for k in STATE})
    if with_state:
        a["state"] = {"c": f(B, d), "n": np.abs(f(B, d)), "h": 0.5 * f(B, d),
                      "m": 0.5 * f(B, d)}
    return a


def _jax_block_grads(a):
    """``jax.grad`` of sum(out w) + sum over the final state of (state x its
    weight), by the params, x and the start state."""
    jcfg = _jcfg()

    def loss(p, x, st):
        out, fin = jax_xlstm.slstm_block(p, x, jcfg, state=st)
        return jnp.sum(out * a["w"]) + sum(jnp.sum(fin[k] * a["dfin"][k]) for k in STATE)

    tree = lambda t: jax.tree_util.tree_map(jnp.asarray, t)
    st = tree(a["state"]) if "state" in a else None
    gp, gx, gs = jax.grad(loss, argnums=(0, 1, 2))(tree(a["p"]), jnp.asarray(a["x"]), st)
    out = {f"p.{k}": np.asarray(v) for k, v in gp.items()}
    out["x"] = np.asarray(gx)
    if gs is not None:
        out.update({f"state.{k}": np.asarray(v) for k, v in gs.items()})
    return out


def _port_block_grads(a):
    """The same gradient with the recurrence's from ``slstm_bwd_ref``: torch
    autograd through the GEGLU projections gives dhs, the reverse
    recurrence gives dwx, dr and the start state's, and the input
    projection's follow from dwx by hand. Also returns what the forward
    kept."""
    t = lambda x: torch.from_numpy(np.ascontiguousarray(x))
    p = {k: t(v) for k, v in a["p"].items()}
    x = t(a["x"])
    B, S, d = x.shape
    state = tuple(t(a["state"][k]) for k in STATE) if "state" in a else None
    wx = torch.matmul(x, p["w_gates"]) + p["b_gates"]
    hs, _, kept = slstm_ref(wx, p["r_gates"], state, keep=True)
    hl = hs.clone().requires_grad_()
    post = {k: p[k].clone().requires_grad_() for k in ("up_proj", "down_proj")}
    u, v = torch.matmul(hl, post["up_proj"]).chunk(2, dim=-1)
    out = torch.matmul(F.gelu(u, approximate="tanh") * v, post["down_proj"])
    (out * t(a["w"])).sum().backward()
    dfin = tuple(t(a["dfin"][k]) for k in STATE)
    dwx, dr, dstate0 = slstm_bwd_ref(p["r_gates"], state, hs, kept, hl.grad, dfin)
    flat = dwx.reshape(B * S, 4 * d)
    got = {"x": torch.matmul(dwx, p["w_gates"].T),
           "p.w_gates": torch.matmul(x.reshape(B * S, d).T, flat),
           "p.b_gates": flat.sum(0), "p.r_gates": dr,
           "p.up_proj": post["up_proj"].grad, "p.down_proj": post["down_proj"].grad}
    if dstate0 is not None:
        got.update({f"state.{k}": g for k, g in zip(STATE, dstate0)})
    return {k: v.numpy() for k, v in got.items()}, kept


@pytest.mark.parametrize("with_state", [False, True], ids=["zero-state", "with-state"])
@pytest.mark.parametrize("S", [20, 64], ids=["one-chunk", "chunks-of-64"])
def test_slstm_bwd_ref_matches_jax_grad(S, with_state):
    a = _block_inputs(2, S, 128, seed=S + with_state, with_state=with_state)
    want = _jax_block_grads(a)
    got, kept = _port_block_grads(a)
    assert set(got) == set(want)
    for k, w in want.items():
        assert float(np.abs(got[k]).max()) > 0, k
        atol = max(GRAD_TOL["atol"], LEAF_ATOL_SCALE * float(np.abs(w).max()))
        np.testing.assert_allclose(got[k], w, rtol=GRAD_TOL["rtol"], atol=atol, err_msg=k)
    if not with_state:
        # the first step from a zero state: n == 1 exactly wherever i~ > f~
        n1 = int((kept[2][:, 0] == 1.0).sum())
        assert 0 < n1 < kept[2][:, 0].numel(), n1


def _tie_inputs(B, S, d, seed, with_state, ties):
    """f64 inputs for the comparison with autograd. With ``ties``, r's i and
    f columns are zero, so i~ and f~ are wx's exactly and m does not depend
    on h: wx's i~ is then set to f~ + m_{t-1} (computed as ``slstm_ref``
    does) at every third step of every other unit, and at the first step
    from a zero state that is a tie with n == 1."""
    rng = np.random.RandomState(seed)
    wx = rng.randn(B, S, 4 * d)
    r = 0.5 * rng.randn(d, 4 * d) / np.sqrt(d)
    state = ((rng.randn(B, d), np.abs(rng.randn(B, d)), 0.5 * rng.randn(B, d),
              0.5 * rng.randn(B, d)) if with_state else None)
    if ties:
        r[:, d:3 * d] = 0.0
        m = state[3].copy() if with_state else np.zeros((B, d))
        for t in range(S):
            it, ft = wx[:, t, d:2 * d], wx[:, t, 2 * d:3 * d]
            if t % 3 == 0:
                it[:, ::2] = ft[:, ::2] + m[:, ::2]
            m = np.maximum(ft + m, it)
    tt = lambda x: torch.from_numpy(x)
    return (tt(wx), tt(r), None if state is None else tuple(tt(x) for x in state),
            tt(rng.randn(B, S, d)), tuple(tt(rng.randn(B, d)) for _ in STATE))


@pytest.mark.parametrize("ties", [False, True], ids=["no-ties", "forced-ties"])
@pytest.mark.parametrize("with_state", [False, True], ids=["zero-state", "with-state"])
def test_slstm_bwd_ref_matches_torch_autograd_f64(with_state, ties):
    wx, r, state, dhs, dfin = _tie_inputs(2, 19, 32, seed=7, with_state=with_state, ties=ties)
    leaves = [wx.clone().requires_grad_(), r.clone().requires_grad_()] + [
        x.clone().requires_grad_() for x in (state or ())]
    hs, fin = slstm_ref(leaves[0], leaves[1], tuple(leaves[2:]) or None)
    loss = (hs * dhs).sum() + sum((x * w).sum() for x, w in zip(fin, dfin))
    loss.backward()
    hs_, _, kept = slstm_ref(wx, r, state, keep=True)
    assert torch.equal(hs_, hs.detach())
    if ties:
        d = r.shape[0]
        m_prev = torch.cat([state[3][:, None] if state else torch.zeros_like(kept[3][:, :1]),
                            kept[3][:, :-1]], dim=1)
        tie = kept[0][..., 2 * d:3 * d] + m_prev == kept[0][..., d:2 * d]
        assert int(tie.sum()) >= 2 * 7 * d // 2, int(tie.sum())
        if state is None:
            assert bool((kept[2][:, 0, ::2] == 1.0).all())
    dwx, dr, dstate0 = slstm_bwd_ref(r, state, hs_, kept, dhs, dfin)
    np.testing.assert_allclose(dwx.numpy(), leaves[0].grad.numpy(), **F64_TOL, err_msg="dwx")
    np.testing.assert_allclose(dr.numpy(), leaves[1].grad.numpy(), **F64_TOL, err_msg="dr")
    assert (dstate0 is None) == (state is None)
    for name, g, leaf in zip(STATE, dstate0 or (), leaves[2:]):
        np.testing.assert_allclose(g.numpy(), leaf.grad.numpy(), **F64_TOL, err_msg=name)


def _leaves(seed, with_state):
    wx, r, state, dhs, dfin = _tie_inputs(2, 23, 64, seed, with_state, ties=False)
    f32 = lambda x: x.float().requires_grad_()
    return f32(wx), f32(r), tuple(f32(x) for x in state or ()) or None, dhs.float(), tuple(
        x.float() for x in dfin)


@pytest.mark.parametrize("with_state", [False, True], ids=["zero-state", "with-state"])
def test_slstm_autograd_on_cpu_runs_the_plain_versions(with_state):
    """``slstm`` with inputs that need a gradient goes through ``_SLSTM``:
    on CPU tensors its forward is ``slstm_ref`` (the same bits) and its
    backward ``slstm_bwd_ref``; no kernel is launched, and without a
    gradient nothing changes. A final state that nothing uses gets no
    gradient (its dc, dn, dh, dm arrive as None)."""
    wx, r, state, dhs, dfin = _leaves(3, with_state)
    before = (kernel.launches, kernel.launches_bwd)
    hs, fin = slstm(wx, r, state)
    plain = lambda *xs: tuple(x.detach() for x in xs)
    rhs, rfin, kept = slstm_ref(*plain(wx, r), plain(*state) if state else None, keep=True)
    assert torch.equal(hs.detach(), rhs)
    assert all(torch.equal(a.detach(), b) for a, b in zip(fin, rfin))
    (hs * dhs).sum().backward()
    want = slstm_bwd_ref(r.detach(), plain(*state) if state else None, rhs, kept, dhs, None)
    assert torch.equal(wx.grad, want[0]) and torch.equal(r.grad, want[1])
    for leaf, g in zip(state or (), want[2] or ()):
        assert torch.equal(leaf.grad, g)
    # the final state's gradient, when it is used
    for x in (wx, r, *(state or ())):
        x.grad = None
    hs, fin = slstm(wx, r, state)
    ((hs * dhs).sum() + sum((x * w).sum() for x, w in zip(fin, dfin))).backward()
    want = slstm_bwd_ref(r.detach(), plain(*state) if state else None, rhs, kept, dhs, dfin)
    assert torch.equal(wx.grad, want[0]) and torch.equal(r.grad, want[1])
    assert (kernel.launches, kernel.launches_bwd) == before
    with torch.no_grad():
        assert torch.equal(slstm(wx, r, state)[0], rhs)


def test_slstm_refuses_what_it_does_not_take():
    """On a device that is none of CUDA, the meta device (the dry run's
    route: the kernels' allocations, no launch, no plain version) and the
    CPU the entry point raises, and the kernel wrappers never take a CPU
    tensor: no fallback to the plain versions."""
    wx, r, state, dhs, _ = _leaves(4, True)
    meta = lambda x: x.detach().to("meta")
    other = types.SimpleNamespace(device=torch.device("xpu"), requires_grad=False)
    with pytest.raises(ValueError, match="unsupported device"):
        ops.slstm(other, meta(r))
    hs, fin = ops.slstm(meta(wx), meta(r))
    hs2, _ = ops.slstm(meta(wx).requires_grad_(), meta(r))
    assert hs.device.type == hs2.device.type == "meta" and hs.shape == (*wx.shape[:2], wx.shape[2] // 4)
    assert (kernel.launches, kernel.launches_bwd) == (0, 0)
    with pytest.raises(ValueError, match="CUDA"):
        kernel.slstm(wx.detach(), r.detach())
    with pytest.raises(ValueError, match="CUDA"):
        kernel.slstm(wx.detach(), r.detach(), tuple(x.detach() for x in state), keep=True)
    hs, _, kept = slstm_ref(wx.detach(), r.detach(), None, keep=True)
    with pytest.raises(ValueError, match="CUDA"):
        kernel.slstm_bwd(r.detach(), None, hs, kept, dhs)
    assert (kernel.launches, kernel.launches_bwd) == (0, 0)


_FWD_CASES = [(1, 1, 128), (8, 1, 1024), (1, 2, 128), (3, 64, 96)]


@pytest.mark.parametrize("which,B,S,d", [
    *(pytest.param("fwd", *c, id="-".join(map(str, c))) for c in _FWD_CASES),
    *(pytest.param(w, *c, id=f"{w}-" + "-".join(map(str, c)))
      for w in ("bwd", "bwd-state") for c in _FWD_CASES)])
def test_slstm_exchange_buffer(which, B, S, d):
    """The kernels' exchanges, each two slots (by the step's parity) of
    64-bit words, zeroed, since a kernel tags each step's words with a
    nonzero count and a zero tag is no step's: the forward's (B, d) of h
    (tag t + 1), the backward's (B, d / 8, d) of each block's share of
    dpre r^T for every unit (tag S - t). A single step crosses no exchange
    and gets none, except in the backward from a start state, whose dh0
    reads step 0's shares."""
    cpu = torch.device("cpu")
    if which == "fwd":
        x, shape, crosses = kernel._exchange(B, S, d, cpu), (2, B, d), S > 1
    else:
        state = which == "bwd-state"
        x = kernel._bwd_exchange(B, S, d, state, cpu)
        shape, crosses = (2, B, d // kernel.UNITS, d), S > 1 or state
    if not crosses:
        assert x is None
    else:
        assert x.shape == shape and x.dtype == torch.int64 and not bool(x.any())
