"""The port's hybrid (Hymba) training against the JAX package's, on the
CPU: the selective scan's gradient, the Mamba block's, and three training
steps of reduced hymba-1.5b.

``ssm_scan_bwd_ref``, the plain adjoint recurrence (the CUDA backward
kernel's plain version, and what the scan's autograd Function runs on the
CPU), is held against ``jax.grad`` of the reference's scan oracle
(``repro.kernels.ssm_scan.ref.ssm_scan_ref``) and against torch autograd
through the port's ``ssm_scan_ref``, on the SSM_CASES rows of
``tests/test_kernels.py``, with and without a start state (and the final
state's gradient). The reference initializes ``A_log`` to ones, so every
channel and state decays alike and a gradient that mixed up A's indices
would pass: every test here draws ``A_log`` and ``D`` spread out (and the
biases ``conv_b`` and ``dt_bias`` nonzero), and
``test_a_wrong_dA_index_fails`` shows that the comparison then sees the
index. Inputs are made with numpy from a seed. Tolerances: the scan's
gradients in f32 at atol=rtol=1e-4 (the JAX test's for the final state;
at bf16, du within half a bf16 ulp of the reference's f32 du on the same
bf16 values); the Mamba block's leaf gradients atol=rtol=1e-4 (XLA and torch sum
matmuls in different orders); training loss and grad norm rtol 1e-4,
params atol 1e-5.
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
from repro.kernels.ssm_scan.ref import ssm_scan_ref as jax_ssm_scan_ref
from repro.models import build_model as jax_build_model
from repro.models import ssm as jax_ssm
from repro.train import steps as jax_steps
from repro_torch.config import ShardingLayout, TrainConfig, get_arch
from repro_torch.data import SyntheticLM
from repro_torch.kernels.ssm_scan import kernel, ssm_scan, ssm_scan_bwd_ref, ssm_scan_ref
from repro_torch.models import build_model, ssm
from repro_torch.models.convert import (
    params_from_jax,
    train_state_from_jax,
    train_state_to_numpy,
)
from repro_torch.models.transformer import layer_slice
from repro_torch.train import steps

F32, BF16 = "float32", "bfloat16"
HYMBA = "hymba-1.5b"
NAMES = ("du", "ddt", "dB_", "dC_", "dA", "dD", "dh0")
GRAD_TOL = dict(atol=1e-4, rtol=1e-4)

# B, S, inner, N, dtype: tests/test_kernels.py SSM_CASES (its chunk column
# has no counterpart here)
SSM_CASES = [
    (2, 128, 256, 16, F32),
    (1, 96, 128, 8, F32),
    (2, 64, 512, 16, F32),
    (1, 128, 256, 16, BF16),
]


def _scan_inputs(B, S, inner, N, seed):
    """f32 numpy arrays with the JAX test's distributions: A = -exp(0.5 n)
    and D normal, spread over channels and states."""
    rng = np.random.RandomState(seed)
    f = lambda *shape: rng.randn(*shape).astype(np.float32)
    return dict(u=f(B, S, inner), dt=(np.log1p(np.exp(f(B, S, inner))) * 0.1).astype(np.float32),
                B_=f(B, S, N), C_=f(B, S, N), A=-np.exp(0.5 * f(inner, N)).astype(np.float32),
                D=f(inner), h0=f(B, inner, N), dy=f(B, S, inner), dh=f(B, inner, N))


def _bf16(x):
    """Round an f32 array to bf16 and back (to nearest even, as torch does)."""
    return torch.from_numpy(x).to(torch.bfloat16).float().numpy()


def _jax_scan_grads(a, with_h0):
    """``jax.grad`` of sum(y dy) + sum(h dh) through the reference's oracle,
    by u, dt, B_, C_, A, D (and h0), in f32."""
    args = [jnp.asarray(a[k]) for k in ("u", "dt", "B_", "C_", "A", "D")]
    h0 = jnp.asarray(a["h0"]) if with_h0 else None
    dy, dh = jnp.asarray(a["dy"]), jnp.asarray(a["dh"])

    def loss(u, dt, B_, C_, A, D, h0):
        y, h = jax_ssm_scan_ref(u, dt, B_, C_, A, D, h0)
        out = jnp.sum(y * dy)
        return out + (jnp.sum(h * dh) if with_h0 else 0.0)

    argnums = tuple(range(7 if with_h0 else 6))
    g = jax.grad(loss, argnums=argnums)(*args, h0)
    return [np.asarray(x, np.float32) for x in g] + ([] if with_h0 else [None])


def _torch_args(a, with_h0, dtype):
    t = {k: torch.from_numpy(v.copy()) for k, v in a.items()}
    if dtype == BF16:
        t["u"] = t["u"].to(torch.bfloat16)
        t["dy"] = torch.from_numpy(_bf16(a["dy"])).to(torch.bfloat16)
    if not with_h0:
        t["h0"] = t["dh"] = None
    return t


@pytest.mark.parametrize("with_h0", [True, False], ids=["h0", "no-h0"])
@pytest.mark.parametrize("case", SSM_CASES, ids=[str(c) for c in SSM_CASES])
def test_ssm_scan_bwd_ref_matches_jax_grad(case, with_h0):
    """At bf16, u and dy (which arrives in y's dtype) are rounded to bf16
    and the reference differentiates their values in f32: the port sums du
    in f32 and rounds it to bf16 once (as the kernel does), where XLA
    rounds each term of du to bf16 before adding them, which can cancel to
    another bf16 value; so du is held at half a bf16 ulp of the f32 sum."""
    B, S, inner, N, dtype = case
    a = _scan_inputs(B, S, inner, N, seed=S + inner + N)
    if dtype == BF16:
        a["u"], a["dy"] = _bf16(a["u"]), _bf16(a["dy"])
    want = _jax_scan_grads(a, with_h0)
    t = _torch_args(a, with_h0, dtype)
    got = ssm_scan_bwd_ref(t["u"], t["dt"], t["B_"], t["C_"], t["A"], t["D"], t["h0"], t["dy"],
                           t["dh"])
    assert got[0].dtype == t["u"].dtype and all(g.dtype == torch.float32 for g in got[1:6])
    for name, g, w in zip(NAMES, got, want):
        if w is None:
            assert g is None, name
            continue
        tol = dict(atol=1e-6, rtol=2 ** -8) if (name == "du" and dtype == BF16) else GRAD_TOL
        np.testing.assert_allclose(g.float().numpy(), w, **tol, err_msg=name)


@pytest.mark.parametrize("with_h0", [True, False], ids=["h0", "no-h0"])
@pytest.mark.parametrize("case", SSM_CASES[:2], ids=[str(c) for c in SSM_CASES[:2]])
def test_ssm_scan_bwd_ref_matches_torch_autograd(case, with_h0):
    B, S, inner, N, dtype = case
    a = _scan_inputs(B, S, inner, N, seed=7 * S + N)
    t = _torch_args(a, with_h0, dtype)
    leaves = [t[k].clone().requires_grad_() for k in ("u", "dt", "B_", "C_", "A", "D")]
    if with_h0:
        leaves.append(t["h0"].clone().requires_grad_())
    y, h = ssm_scan_ref(*leaves[:6], leaves[6] if with_h0 else None)
    loss = (y * t["dy"]).sum() + ((h * t["dh"]).sum() if with_h0 else 0.0)
    want = torch.autograd.grad(loss, leaves)
    got = ssm_scan_bwd_ref(*(t[k] for k in ("u", "dt", "B_", "C_", "A", "D", "h0", "dy", "dh")))
    for name, g, w in zip(NAMES, got, want):
        np.testing.assert_allclose(g.numpy(), w.numpy(), **GRAD_TOL, err_msg=name)
    assert (got[6] is None) == (not with_h0)


def test_scan_autograd_on_cpu_runs_the_plain_versions():
    """``ssm_scan`` with inputs that need a gradient goes through the
    autograd Function: on CPU tensors its forward is ``ssm_scan_ref`` (the
    same bits) and its backward ``ssm_scan_bwd_ref``; no kernel is launched,
    and without a gradient nothing changes."""
    a = _scan_inputs(2, 21, 24, 8, seed=3)
    t = _torch_args(a, True, F32)
    leaves = {k: t[k].clone().requires_grad_() for k in ("u", "dt", "B_", "C_", "A", "D", "h0")}
    before = (kernel.launches, kernel.launches_bwd)
    y, h = ssm_scan(**leaves)
    ry, rh = ssm_scan_ref(**{k: v.detach() for k, v in leaves.items()})
    assert torch.equal(y.detach(), ry) and torch.equal(h.detach(), rh)
    ((y * t["dy"]).sum() + (h * t["dh"]).sum()).backward()
    want = ssm_scan_bwd_ref(*(t[k] for k in ("u", "dt", "B_", "C_", "A", "D", "h0", "dy", "dh")))
    for name, key, w in zip(NAMES, ("u", "dt", "B_", "C_", "A", "D", "h0"), want):
        assert torch.equal(leaves[key].grad, w), name
    assert (kernel.launches, kernel.launches_bwd) == before
    with torch.no_grad():
        assert torch.equal(ssm_scan(**leaves)[0], ry)


def test_kernel_wrapper_refuses_cpu_tensors():
    t = _torch_args(_scan_inputs(1, 20, 16, 8, seed=4), True, F32)
    args = [t[k] for k in ("u", "dt", "B_", "C_", "A", "D", "h0")]
    with pytest.raises(ValueError, match="CUDA"):
        kernel.ssm_scan_bwd(*args, torch.zeros((1, kernel.n_chunks(20), 16, 8)), t["dy"])
    assert [kernel.n_chunks(s) for s in (1, 4, 5, 16, 17, 32, 33, 4096)] == [
        0, 0, 0, 0, 1, 1, 2, 255]


def test_a_wrong_dA_index_fails():
    """A gradient that reads A with its states reversed, everything else
    equal: with A spread out (as drawn here) it misses ``jax.grad`` by far
    more than the tolerance; with the reference's init (A_log ones, every
    channel and state alike) it passes, which is why A is drawn."""
    B, S, inner, N, _ = SSM_CASES[0]
    keys = ("u", "dt", "B_", "C_", "A", "D", "h0", "dy", "dh")
    for spread in (True, False):
        a = _scan_inputs(B, S, inner, N, seed=11)
        if not spread:
            a["A"] = np.full_like(a["A"], -np.e)     # -exp(A_log) at A_log = 1
        want = _jax_scan_grads(a, True)
        t = _torch_args(a, True, F32)
        t["A"] = t["A"].flip(-1)
        mutant = ssm_scan_bwd_ref(*(t[k] for k in keys))
        close = all(np.allclose(g.numpy(), w, **GRAD_TOL) for g, w in zip(mutant, want))
        assert close == (not spread), spread


# ---------------------------------------------------------------------------
# the Mamba block and reduced hymba training
# ---------------------------------------------------------------------------

def _spread(tree, rng):
    """The JAX params with every Mamba block's ``A_log`` drawn N(1, 0.5), ``D``
    N(1, 0.5) and ``conv_b``, ``dt_bias`` N(0, 0.5) (``init`` gives ones
    and zeros), and the fuse norms' scales 1 + N(0, 0.2); the rest shared."""
    out = dict(tree)
    blocks = dict(tree["blocks"])
    mamba = dict(blocks["mamba"])
    for key, mean in (("A_log", 1.0), ("D", 1.0), ("conv_b", 0.0), ("dt_bias", 0.0)):
        mamba[key] = (mean + 0.5 * rng.randn(*mamba[key].shape)).astype(np.float32)
    blocks["mamba"] = mamba
    for key in ("fuse_attn", "fuse_ssm"):
        blocks[key] = {"scale": (1.0 + 0.2 * rng.randn(*blocks[key]["scale"].shape)
                                 ).astype(np.float32)}
    out["blocks"] = blocks
    return out


def _cfgs():
    return (dataclasses.replace(jax_get_arch(HYMBA).reduced(), dtype=F32),
            dataclasses.replace(get_arch(HYMBA).reduced(), dtype=F32))


@functools.lru_cache(maxsize=None)
def _jax_params():
    jcfg, _ = _cfgs()
    tree = jax.tree_util.tree_map(np.asarray, jax_build_model(jcfg).init(jax.random.key(0)))
    return _spread(tree, np.random.RandomState(1))


@pytest.mark.parametrize("S", [24, 20], ids=["chunks-of-8", "chunk-1"])
def test_mamba_block_gradients_match_jax(S):
    """Every leaf of one Mamba block, and its input, under ``jax.grad`` of
    sum(out w) (w a numpy draw): S = 24 runs the reference's chunked scan,
    S = 20 (not a multiple of its chunk of 8) its one-step chunks."""
    jcfg, cfg = _cfgs()
    tree = _jax_params()
    jp = jax.tree_util.tree_map(lambda a: jnp.asarray(a[0]), tree["blocks"]["mamba"])
    tp = layer_slice(params_from_jax(tree, cfg, "cpu")["blocks"], 0)["mamba"]
    rng = np.random.RandomState(S)
    x = rng.randn(2, S, cfg.d_model).astype(np.float32)
    w = rng.randn(2, S, cfg.d_model).astype(np.float32)

    def loss(p, xx):
        out, _ = jax_ssm.mamba_block(p, xx, jcfg)
        return jnp.sum(out * w)

    jg, jgx = jax.grad(loss, argnums=(0, 1))(jp, jnp.asarray(x))
    leaves = {k: v.detach().clone().requires_grad_() for k, v in tp.items()}
    xt = torch.from_numpy(x).requires_grad_()
    out, _ = ssm.mamba_block(leaves, xt, cfg)
    (out * torch.from_numpy(w)).sum().backward()
    np.testing.assert_allclose(xt.grad.numpy(), np.asarray(jgx), **GRAD_TOL, err_msg="x")
    for k, v in leaves.items():
        assert v.grad is not None and float(v.grad.abs().max()) > 0, k
        np.testing.assert_allclose(v.grad.numpy(), np.asarray(jg[k]), **GRAD_TOL, err_msg=k)


@pytest.mark.parametrize("remat", ["full", "none"])
def test_train_step_matches_jax(remat):
    """3 steps of reduced hymba (batch 4 in 2 microbatches, seq 24, window
    8): loss and grad norm at every step, then params (the Mamba leaves
    moved) and moments; the ``keep_f32`` leaves and every moment stay f32."""
    jcfg, cfg = _cfgs()
    jstate0 = jax.tree_util.tree_map(
        np.asarray, jax_steps.init_train_state(jax_build_model(jcfg), jax.random.key(0)))
    jstate0 = jstate0._replace(params=_jax_params())
    jtc = JaxTrainConfig(total_steps=10, warmup_steps=2, microbatches=2)
    jstep = jax.jit(jax_steps.build_train_step(jax_build_model(jcfg), jtc,
                                               JaxLayout(q_chunk=8, kv_chunk=8, remat=remat),
                                               constrain=None))
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
    mamba = state.params["blocks"]["mamba"]
    for key in ("A_log", "x_proj", "dt_proj"):
        assert mamba[key].dtype == torch.float32, key
    assert all(t.dtype == torch.float32 for tree in (state.opt.m, state.opt.v)
               for t in jax.tree_util.tree_leaves(tree))
    ours, ref = train_state_to_numpy(state), jax.tree_util.tree_map(np.asarray, jstate)
    for tree, want in ((ours.params, ref.params), (ours.opt.m, ref.opt.m)):
        for (path, b), a in zip(jax.tree_util.tree_leaves_with_path(want),
                                jax.tree_util.tree_leaves(tree)):
            np.testing.assert_allclose(a, b, atol=1e-5, rtol=0, err_msg=str(path))
    start = jstate0.params["blocks"]["mamba"]
    for key in ("A_log", "D", "conv_b", "dt_bias", "x_proj", "in_proj", "out_proj"):
        assert float(np.abs(ours.params["blocks"]["mamba"][key] - start[key]).max()) > 0, key
