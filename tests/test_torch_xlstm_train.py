"""The port's xLSTM training against the JAX package's, on the CPU: the
mLSTM's gradient, the xLSTM blocks', and three training steps of reduced
xlstm-350m.

``mlstm_chunkwise_bwd_ref``, the hand-derived backward of the chunkwise
form (the CUDA backward kernel's plain version, and what the mLSTM's
autograd Function runs on the CPU), is held against ``jax.grad`` of the
reference's model scan (``repro.models.xlstm._mlstm_scan``) and of its
sequential oracle (``repro.kernels.mlstm.ref.mlstm_ref``), and against
torch autograd through the port's ``mlstm_chunkwise_ref``, on the
MLSTM_CASES rows of ``tests/test_kernels.py`` in f32, with and without a
start state (and then the final state's gradient too). Its stabilizer term
(the reverse pass along m's argmax chain, fed at clamped steps) is no
rounding detail: at the JAX test's gate scale most steps are clamped, and
a gradient without the term misses ``jax.grad`` by far more than the
tolerance. Inputs are made with numpy from a seed. Tolerances: gradients
atol=rtol=1e-4 (the JAX scan test's); training loss and grad norm rtol
1e-4, params and moments atol 1e-5.
"""
import dataclasses
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.config import ShardingLayout as JaxLayout
from repro.config import TrainConfig as JaxTrainConfig
from repro.config import get_arch as jax_get_arch
from repro.data import SyntheticLM as JaxSyntheticLM
from repro.kernels.mlstm.ref import mlstm_ref as jax_mlstm_ref
from repro.models import build_model as jax_build_model
from repro.models import xlstm as jax_xlstm
from repro.train import steps as jax_steps
from repro_torch.config import ShardingLayout, TrainConfig, get_arch
from repro_torch.data import SyntheticLM
from repro_torch.kernels.mlstm import kernel, mlstm, mlstm_chunkwise_bwd_ref, mlstm_chunkwise_ref
from repro_torch.kernels.mlstm import ref as mlstm_ref_module
from repro_torch.kernels.mlstm.ref import mlstm_bwd_carry_tiles_ref
from repro_torch.launch import train as train_launcher
from repro_torch.models import build_model, transformer, xlstm
from repro_torch.models.convert import params_from_jax, train_state_from_jax, train_state_to_numpy
from repro_torch.train import steps

F32 = "float32"
XLSTM = "xlstm-350m"
GRAD_TOL = dict(atol=1e-4, rtol=1e-4)
# A block's leaf gradient sums many terms in orders that differ between XLA
# and torch: ``w_if``'s (terms up to ~50 whose sums are ~0.3) carries
# ~2.5e-4 of that rounding, and torch autograd through the plain forward
# is as far from ``jax.grad`` there. The leaves' absolute tolerance is
# GRAD_TOL's or 1e-5 of the leaf's largest gradient, whichever is larger.
LEAF_ATOL_SCALE = 1e-5
# A parameter element whose gradient is rounding noise in every step (an RMS
# under 1e-9, a tenth of AdamW's eps): its second moment stays under
# NOISE_V and its first moment under NOISE_M on both sides.
NOISE_V, NOISE_M = 1e-18, 1e-8
NAMES = ("dq", "dk", "dv", "dgates", "dC0", "dn0", "dm0")

# B, H, S, hd, chunk (the JAX kernel's, here the model scan's): tests/test_kernels.py
# MLSTM_CASES, every row in f32 (its last row is bf16 there)
MLSTM_CASES = [
    (2, 2, 128, 64, 32),
    (1, 4, 64, 32, 64),
    (2, 1, 96, 128, 16),
    (1, 2, 128, 64, 64),
]


def _inputs(B, H, S, hd, seed, with_state):
    """f32 numpy arrays in the model's layout with the JAX test's
    distributions: q, k, v (B,S,H,hd) normal, gates (B,S,2H) 2 x normal; a
    start state (C, n normal, m 0.5 x normal); dh and the final state's
    dC, dn, dm normal."""
    rng = np.random.RandomState(seed)
    f = lambda *shape: rng.randn(*shape).astype(np.float32)
    a = dict(q=f(B, S, H, hd), k=f(B, S, H, hd), v=f(B, S, H, hd), g=2 * f(B, S, 2 * H),
             dh=f(B, S, H, hd))
    if with_state:
        a["state"] = (f(B, H, hd, hd), f(B, H, hd), 0.5 * f(B, H))
        a["dstate"] = (f(B, H, hd, hd), f(B, H, hd), f(B, H))
    return a


def _jax_grads(a, chunk, scan):
    """``jax.grad`` of sum(h dh) (+ the final state against dC, dn, dm with
    a start state) by q, k, v, gates (and the start state), through the
    model's chunkwise scan or the sequential oracle."""
    with_state = "state" in a
    B, S, H, hd = a["q"].shape

    def loss(q, k, v, g, C0, n0, m0):
        if scan:
            st = {"C": C0, "n": n0, "m": m0} if with_state else {
                "C": jnp.zeros((B, H, hd, hd)), "n": jnp.zeros((B, H, hd)),
                "m": jnp.zeros((B, H))}
            h, fin = jax_xlstm._mlstm_scan(q, k, v, g, st, chunk)
            fin = (fin["C"], fin["n"], fin["m"])
        else:
            t = lambda x: x.swapaxes(1, 2)
            gs = jnp.stack([g[..., :H], g[..., H:]], -1).swapaxes(1, 2)
            hr, fin = jax_mlstm_ref(t(q), t(k), t(v), gs,
                                    (C0, n0, m0) if with_state else None)
            h = t(hr)
        out = jnp.sum(h * a["dh"])
        if with_state:
            out += sum(jnp.sum(x * d) for x, d in zip(fin, a["dstate"]))
        return out

    st = a["state"] if with_state else (None, None, None)
    argnums = tuple(range(7 if with_state else 4))
    g = jax.grad(loss, argnums=argnums)(*(jnp.asarray(a[x]) for x in ("q", "k", "v", "g")),
                                        *(None if x is None else jnp.asarray(x) for x in st))
    return [np.asarray(x, np.float32) for x in g]


def _bwd_ref(a, chunk):
    t = lambda x: torch.from_numpy(np.ascontiguousarray(x))
    q, k, v, g = (t(a[x]) for x in ("q", "k", "v", "g"))
    state = tuple(t(x) for x in a["state"]) if "state" in a else None
    dstate = tuple(t(x) for x in a["dstate"]) if "dstate" in a else None
    h, _ = mlstm_chunkwise_ref(q, k, v, g, state, chunk)
    out = mlstm_chunkwise_bwd_ref(q, k, v, g, state, h, t(a["dh"]), dstate, chunk)
    return [x.numpy() for x in (*out[:4], *(out[4] or ()))]


def _clamped_share(a) -> float:
    """The share of steps whose denominator max(|n_t.q_t|, 1) is clamped,
    from the plain recurrence."""
    t = lambda x: torch.from_numpy(x)
    q, k, g = t(a["q"]), t(a["k"]), t(a["g"])
    B, S, H, hd = q.shape
    n = t(a["state"][1]) if "state" in a else torch.zeros(B, H, hd)
    m = t(a["state"][2]) if "state" in a else torch.zeros(B, H)
    clamped = 0
    for s in range(S):
        it, ft = g[:, s, :H], g[:, s, H:]
        m_new = torch.maximum(ft + m, it)
        n = torch.exp(ft + m - m_new)[..., None] * n + torch.exp(it - m_new)[..., None] * (
            k[:, s] / np.sqrt(hd))
        clamped += int(((n * q[:, s]).sum(-1).abs() <= 1).sum())
        m = m_new
    return clamped / (B * S * H)


@pytest.mark.parametrize("with_state", [True, False], ids=["state", "no-state"])
@pytest.mark.parametrize("case", MLSTM_CASES, ids=[str(c) for c in MLSTM_CASES])
def test_mlstm_bwd_ref_matches_jax_grad(case, with_state):
    """Against ``jax.grad`` of the model's chunkwise scan at the row's chunk
    and of the sequential oracle; the port's backward runs at the model's
    chunk 64 (the kernels')."""
    B, H, S, hd, chunk = case
    a = _inputs(B, H, S, hd, seed=S + hd + chunk, with_state=with_state)
    got = _bwd_ref(a, 64)
    for scan in (True, False):
        want = _jax_grads(a, chunk, scan)
        assert len(got) == len(want)
        for name, x, w in zip(NAMES, got, want):
            np.testing.assert_allclose(x, w, **GRAD_TOL, err_msg=f"{name} (scan={scan})")


@pytest.mark.parametrize("S,chunk", [(100, 32), (40, 16), (64, 64)], ids=["ragged", "40", "64"])
def test_mlstm_bwd_ref_matches_torch_autograd(S, chunk):
    """Against torch autograd through ``mlstm_chunkwise_ref`` from a start
    state, with the final state's gradient; S 100 is ragged against the
    chunk (padded with ĩ = -1e30)."""
    a = _inputs(2, 2, S, 16, seed=S, with_state=True)
    t = lambda x: torch.from_numpy(x.copy())
    leaves = [t(a[x]).requires_grad_() for x in ("q", "k", "v", "g")] + [
        t(x).requires_grad_() for x in a["state"]]
    h, fin = mlstm_chunkwise_ref(*leaves[:4], tuple(leaves[4:]), chunk)
    loss = (h * t(a["dh"])).sum() + sum((x * t(d)).sum() for x, d in zip(fin, a["dstate"]))
    want = torch.autograd.grad(loss, leaves)
    got = _bwd_ref(a, chunk)
    for name, x, w in zip(NAMES, got, want):
        np.testing.assert_allclose(x, w.numpy(), **GRAD_TOL, err_msg=name)


@pytest.mark.parametrize("case", MLSTM_CASES, ids=[str(c) for c in MLSTM_CASES])
def test_mlstm_bwd_ref_in_f64(case):
    """Given f64 inputs (the f32 ones widened, the f32 forward's h) the
    plain backward returns every output in f64, the witness the card holds
    the kernel against; it matches ``jax.grad`` of the model's scan, and
    the f32 version matches it."""
    B, H, S, hd, chunk = case
    a = _inputs(B, H, S, hd, seed=S + hd, with_state=True)
    t = lambda x: torch.from_numpy(np.ascontiguousarray(x))
    q, k, v, g = (t(a[x]) for x in ("q", "k", "v", "g"))
    state, dstate = tuple(t(x) for x in a["state"]), tuple(t(x) for x in a["dstate"])
    h, _ = mlstm_chunkwise_ref(q, k, v, g, state, 64)
    f64 = lambda ts: tuple(x.double() for x in ts)
    out = mlstm_chunkwise_bwd_ref(*f64((q, k, v, g)), f64(state), *f64((h, t(a["dh"]))),
                                  f64(dstate), 64)
    wit = [*out[:4], *out[4]]
    assert all(x.dtype == torch.float64 for x in wit)
    for name, x, w, f in zip(NAMES, wit, _jax_grads(a, chunk, scan=True), _bwd_ref(a, 64)):
        np.testing.assert_allclose(x.numpy(), w, **GRAD_TOL, err_msg=f"{name} vs jax.grad")
        np.testing.assert_allclose(f, x.numpy(), **GRAD_TOL, err_msg=f"{name} f32 vs f64")


@pytest.mark.parametrize("case", MLSTM_CASES, ids=[str(c) for c in MLSTM_CASES])
def test_carry_tiles_ref_matches_bwd_ref_and_jax_grad(case):
    """The carry pass as the CUDA kernel splits it (``mlstm_bwd_carry_tiles_ref``:
    the prep's per-step coefficients, then each (value-row tile, column tile)
    of dC and each column tile of the n row stepped back over the chunks on
    its own, at the kernel's tile: 64 where hd % 64 == 0, else 32) gives the
    start state's dC0 and dn0 of ``mlstm_chunkwise_bwd_ref`` (GRAD_TOL) and
    of ``jax.grad`` through the model's scan (GRAD_TOL, the absolute part at
    least LEAF_ATOL_SCALE of the largest value, as for the blocks' leaves:
    dn0 sums S terms up to ~400, and the plain backward itself is 6.3e-4
    off ``jax.grad`` there); the last chunk's end takes the final state's
    gradient, and tiles of 32 give what one tile gives."""
    B, H, S, hd, chunk = case
    a = _inputs(B, H, S, hd, seed=S + hd + 7, with_state=True)
    t = lambda x: torch.from_numpy(np.ascontiguousarray(x))
    q, k, v, g, dh = (t(a[x]) for x in ("q", "k", "v", "g", "dh"))
    state, dstate = tuple(t(x) for x in a["state"]), tuple(t(x) for x in a["dstate"])
    h, _ = mlstm_chunkwise_ref(q, k, v, g, state, 64)
    tile = 64 if hd % 64 == 0 else 32
    dC_end, dn_end, dC0, dn0 = mlstm_bwd_carry_tiles_ref(q, k, v, g, state, h, dh, dstate, 64,
                                                         tile)
    assert dC_end.shape == (B, H, -(-S // 64), hd, hd) and dn_end.shape == (B, H, -(-S // 64), hd)
    assert torch.equal(dC_end[:, :, -1], dstate[0]) and torch.equal(dn_end[:, :, -1], dstate[1])
    want = mlstm_chunkwise_bwd_ref(q, k, v, g, state, h, dh, dstate, 64)[4]
    jax_want = _jax_grads(a, chunk, scan=True)
    for name, x, w, j in (("dC0", dC0, want[0], jax_want[4]), ("dn0", dn0, want[1], jax_want[5])):
        np.testing.assert_allclose(x.numpy(), w.numpy(), **GRAD_TOL, err_msg=f"{name} vs the ref")
        atol = max(GRAD_TOL["atol"], LEAF_ATOL_SCALE * float(np.abs(j).max()))
        np.testing.assert_allclose(x.numpy(), j, atol=atol, rtol=GRAD_TOL["rtol"],
                                   err_msg=f"{name} vs jax.grad")
    whole = mlstm_bwd_carry_tiles_ref(q, k, v, g, state, h, dh, dstate, 64, hd)
    small = mlstm_bwd_carry_tiles_ref(q, k, v, g, state, h, dh, dstate, 64, 32)
    for x, y in zip(small, whole):
        torch.testing.assert_close(x, y, atol=1e-5, rtol=1e-5)


def test_carry_tiles_ref_refuses_a_ragged_tile():
    """A tile that does not divide the head dim is refused, not cut."""
    a = _inputs(1, 1, 20, 64, seed=1, with_state=False)
    t = lambda x: torch.from_numpy(np.ascontiguousarray(x))
    q, k, v, g, dh = (t(a[x]) for x in ("q", "k", "v", "g", "dh"))
    h, _ = mlstm_chunkwise_ref(q, k, v, g, None, 64)
    with pytest.raises(ValueError, match="multiple of tile 48"):
        mlstm_bwd_carry_tiles_ref(q, k, v, g, None, h, dh, None, 64, 48)


def test_dropping_the_stabilizer_term_fails(monkeypatch):
    """The gradient without its part (b), everything else equal: at the JAX
    test's gate scale most steps are clamped and it misses ``jax.grad`` far
    outside the tolerance (the gates' gradient; dq, dk, dv do not depend on
    the stabilizer's path), while the whole gradient holds."""
    B, H, S, hd, chunk = MLSTM_CASES[0]
    a = _inputs(B, H, S, hd, seed=5, with_state=False)
    share = _clamped_share(a)
    assert 0.3 < share < 0.95, share
    want = _jax_grads(a, chunk, scan=True)
    assert all(np.allclose(x, w, **GRAD_TOL) for x, w in zip(_bwd_ref(a, 64), want))
    monkeypatch.setattr(mlstm_ref_module, "_stabilizer_chain",
                        lambda won, e: (torch.zeros_like(e), torch.zeros_like(e),
                                        torch.zeros_like(e[:, 0])))
    mutant = _bwd_ref(a, 64)
    for name, x, w in zip(NAMES[:3], mutant[:3], want[:3]):
        np.testing.assert_allclose(x, w, **GRAD_TOL, err_msg=name)
    gap = float(np.abs(mutant[3] - want[3]).max())
    assert gap > 100 * GRAD_TOL["atol"] * max(1.0, float(np.abs(want[3]).max())), gap


def test_mlstm_autograd_on_cpu_runs_the_plain_versions():
    """``mlstm`` with inputs that need a gradient goes through the autograd
    Function: on CPU tensors its forward is ``mlstm_chunkwise_ref`` (the
    same bits) and its backward ``mlstm_chunkwise_bwd_ref``; no kernel is
    launched, and without a gradient nothing changes. A final state that
    nothing uses gets no gradient."""
    a = _inputs(2, 2, 37, 16, seed=2, with_state=True)
    t = lambda x: torch.from_numpy(x.copy())
    leaves = [t(a[x]).requires_grad_() for x in ("q", "k", "v", "g")] + [
        t(x).requires_grad_() for x in a["state"]]
    counters = ("launches_tc", "launches_tf32", "launches_step", "launches_bwd")
    before = [getattr(kernel, c) for c in counters]
    h, fin = mlstm(*leaves[:4], tuple(leaves[4:]), 8)
    rh, rfin = mlstm_chunkwise_ref(*(x.detach() for x in leaves[:4]),
                                   tuple(x.detach() for x in leaves[4:]), 8)
    assert torch.equal(h.detach(), rh) and all(torch.equal(x.detach(), y)
                                               for x, y in zip(fin, rfin))
    (h * t(a["dh"])).sum().backward()
    want = mlstm_chunkwise_bwd_ref(*(x.detach() for x in leaves[:4]),
                                   tuple(x.detach() for x in leaves[4:]), rh, t(a["dh"]),
                                   None, 8)
    for name, leaf, w in zip(NAMES, leaves, (*want[:4], *want[4])):
        assert torch.equal(leaf.grad, w), name
    assert [getattr(kernel, c) for c in counters] == before
    with torch.no_grad():
        assert torch.equal(mlstm(*leaves[:4], tuple(leaves[4:]), 8)[0], rh)


def test_backward_wrapper_refuses_cpu_tensors():
    a = _inputs(1, 2, 20, 32, seed=3, with_state=False)
    q, k, v, g, dh = (torch.from_numpy(a[x]) for x in ("q", "k", "v", "g", "dh"))
    kept = (torch.zeros(1, 2, 1, 32, 32), torch.zeros(1, 2, 1, 32), torch.zeros(1, 2, 1),
            torch.zeros(1, 20, 2))
    with pytest.raises(ValueError, match="CUDA"):
        kernel.mlstm_bwd(q, k, v, g, q, dh, kept)
    with pytest.raises(ValueError, match="CUDA"):
        kernel.mlstm_chunkwise(q, k, v, g, None, keep=True)


# ---------------------------------------------------------------------------
# the blocks and reduced xlstm-350m training
# ---------------------------------------------------------------------------

def _cfgs():
    return (dataclasses.replace(jax_get_arch(XLSTM).reduced(), dtype=F32),
            dataclasses.replace(get_arch(XLSTM).reduced(), dtype=F32))


def _spread(tree, rng):
    """The JAX params with the biases ``b_if`` and ``b_gates`` drawn N(0,
    0.5) and the norms' scales 1 + N(0, 0.2) (``init`` gives zeros and
    ones); the rest shared."""
    def walk(node):
        if isinstance(node, dict):
            out = {}
            for k, v in node.items():
                if k in ("b_if", "b_gates"):
                    out[k] = (0.5 * rng.randn(*v.shape)).astype(np.float32)
                elif k == "scale":
                    out[k] = (1.0 + 0.2 * rng.randn(*v.shape)).astype(np.float32)
                else:
                    out[k] = walk(v)
            return out
        return node
    return walk(tree)


@functools.lru_cache(maxsize=None)
def _jax_params():
    jcfg, _ = _cfgs()
    tree = jax.tree_util.tree_map(np.asarray, jax_build_model(jcfg).init(jax.random.key(0)))
    return _spread(tree, np.random.RandomState(1))


@pytest.mark.parametrize("S", [24, 20], ids=["chunks-of-8", "chunk-1"])
@pytest.mark.parametrize("kind", ["mlstm", "slstm"])
def test_block_gradients_match_jax(kind, S):
    """Every leaf of group 0's block (layer 0's for the mLSTM), and its
    input, under ``jax.grad`` of sum(out w): S = 24 runs the reference's
    chunks of 8, S = 20 its one-step chunks; the ``keep_f32`` leaves get f32
    gradients."""
    jcfg, cfg = _cfgs()
    take = (lambda x: x[0, 0]) if kind == "mlstm" else (lambda x: x[0])
    jp = jax.tree_util.tree_map(lambda x: jnp.asarray(take(x)), _jax_params()["groups"][kind])
    tp = transformer.layer_slice(params_from_jax(_jax_params(), cfg, "cpu")["groups"], 0)[kind]
    if kind == "mlstm":
        tp = transformer.layer_slice(tp, 0)
    jfn, tfn = getattr(jax_xlstm, f"{kind}_block"), getattr(xlstm, f"{kind}_block")
    rng = np.random.RandomState(S)
    x = rng.randn(2, S, cfg.d_model).astype(np.float32)
    w = rng.randn(2, S, cfg.d_model).astype(np.float32)

    def loss(p, xx):
        out, _ = jfn(p, xx, jcfg)
        return jnp.sum(out * w)

    jg, jgx = jax.grad(loss, argnums=(0, 1))(jp["block"], jnp.asarray(x))
    leaves = {k: v.detach().clone().requires_grad_() for k, v in tp["block"].items()}
    xt = torch.from_numpy(x).requires_grad_()
    out, _ = tfn(leaves, xt, cfg)
    (out * torch.from_numpy(w)).sum().backward()
    np.testing.assert_allclose(xt.grad.numpy(), np.asarray(jgx), **GRAD_TOL, err_msg="x")
    for k, v in leaves.items():
        assert v.grad is not None and v.grad.dtype == torch.float32, k
        assert float(v.grad.abs().max()) > 0, k
        want = np.asarray(jg[k])
        atol = max(GRAD_TOL["atol"], LEAF_ATOL_SCALE * float(np.abs(want).max()))
        np.testing.assert_allclose(v.grad.numpy(), want, rtol=GRAD_TOL["rtol"], atol=atol,
                                   err_msg=k)


def test_per_layer_splits_groups_into_leaves():
    """``per_layer`` turns ``groups`` into a list of groups, each with its
    mLSTM blocks as a list of per-layer trees: views of the stacked leaves."""
    _, cfg = _cfgs()
    params = params_from_jax(_jax_params(), cfg, "cpu")
    out = transformer.per_layer(params, cfg.num_layers)
    n_groups, m_per, has_s = transformer._xlstm_group_layout(cfg)
    assert "blocks" not in out and len(out["groups"]) == n_groups
    for g, grp in enumerate(out["groups"]):
        assert len(grp["mlstm"]) == m_per and ("slstm" in grp) == bool(has_s)
        for i, layer in enumerate(grp["mlstm"]):
            wq = layer["block"]["wq"]
            assert wq.data_ptr() == params["groups"]["mlstm"]["block"]["wq"][g, i].data_ptr()
        assert torch.equal(grp["slstm"]["block"]["r_gates"],
                           params["groups"]["slstm"]["block"]["r_gates"][g])


@pytest.mark.parametrize("remat", ["full", "none"])
def test_train_step_matches_jax(remat):
    """3 steps of reduced xlstm-350m (2 groups of 1 mLSTM + 1 sLSTM; batch 4
    in 2 microbatches, seq 24): loss and grad norm at every step, then
    params and first moments (an element whose gradient was rounding noise
    in every step by its first moments near 0: in this run one element of
    ``embed``, whose gradients of ~1e-10 made AdamW steps 1.2e-5 apart,
    8.3e-6 with torch autograd through the plain forward in place of the
    hand-derived backward); the ``keep_f32`` leaves and every moment stay
    f32, and every mLSTM and sLSTM leaf moved."""
    jcfg, cfg = _cfgs()
    jstate0 = jax.tree_util.tree_map(
        np.asarray, jax_steps.init_train_state(jax_build_model(jcfg), jax.random.key(0)))
    jstate0 = jstate0._replace(params=_jax_params())
    jtc = JaxTrainConfig(total_steps=10, warmup_steps=2, microbatches=2)
    jstep = jax.jit(jax_steps.build_train_step(jax_build_model(jcfg), jtc,
                                               JaxLayout(remat=remat), constrain=None))
    tc = TrainConfig(total_steps=10, warmup_steps=2, microbatches=2)
    step = steps.build_train_step(build_model(cfg), tc,
                                  ShardingLayout(attn_impl="flash", remat=remat))
    jds, ds = JaxSyntheticLM(256, 24, 4, seed=0), SyntheticLM(256, 24, 4, seed=0)
    jstate = jax.tree_util.tree_map(jnp.asarray, jstate0)
    state = train_state_from_jax(jstate0, cfg, "cpu")
    for i in range(3):
        jstate, jm = jstep(jstate, {k: jnp.asarray(v) for k, v in jds.batch(i).items()})
        state, m = step(state, {k: torch.from_numpy(v) for k, v in ds.batch(i).items()})
        for k in ("loss", "grad_norm"):
            np.testing.assert_allclose(float(m[k]), float(jm[k]), rtol=1e-4, err_msg=f"{k} {i}")
    g = state.params["groups"]
    for blk, key in (("mlstm", "w_if"), ("slstm", "w_gates"), ("slstm", "r_gates")):
        assert g[blk]["block"][key].dtype == torch.float32, key
    assert all(t.dtype == torch.float32 for tree in (state.opt.m, state.opt.v)
               for t in jax.tree_util.tree_leaves(tree))
    ours, ref = train_state_to_numpy(state), jax.tree_util.tree_map(np.asarray, jstate)
    leaves = lambda tree: jax.tree_util.tree_leaves(tree)
    for (path, want_p), p, m, want_m, v, want_v in zip(
            jax.tree_util.tree_leaves_with_path(ref.params), leaves(ours.params),
            leaves(ours.opt.m), leaves(ref.opt.m), leaves(ours.opt.v), leaves(ref.opt.v)):
        # an element whose gradient stayed at rounding level (second moment
        # under NOISE_V on both sides) has no update direction: AdamW scales
        # its noise to a step of the learning rate's order, so its first
        # moments are held near 0 instead of its value
        top = np.maximum(v, want_v)
        noise = (top > 0) & (top < NOISE_V)
        assert noise.mean() < 0.01, (path, noise.sum())
        assert np.all(np.abs(m[noise]) < NOISE_M) and np.all(np.abs(want_m[noise]) < NOISE_M)
        for name, a, b in (("param", p, want_p), ("first moment", m, want_m)):
            np.testing.assert_allclose(a[~noise], b[~noise], atol=1e-5, rtol=0,
                                       err_msg=f"{name} {path}")
    start = jstate0.params["groups"]
    for blk in ("mlstm", "slstm"):
        for key, val in start[blk]["block"].items():
            moved = float(np.abs(ours.params["groups"][blk]["block"][key] - val).max())
            assert moved > 0, (blk, key)


def test_train_launcher_runs_xlstm_on_cpu(capsys):
    out = train_launcher.main(["--arch", XLSTM, "--device", "cpu", "--steps", "3"])
    assert np.isfinite(out["loss_first"]) and np.isfinite(out["loss_last"])
    assert '"training done"' in capsys.readouterr().out
