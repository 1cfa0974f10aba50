"""The port's selective scan and Mamba block against the JAX package's, on
the CPU.

``ssm_scan`` on a CPU tensor runs the plain ``ssm_scan_ref``; it is held
against the JAX Pallas kernel in interpret mode and against the JAX
``ssm_scan_ref``, on the SSM_CASES rows of ``tests/test_kernels.py``
(copied), with that test's tolerances: y at 2e-5 (f32) or 2e-2 (bf16), the
final state at 1e-4. ``ssm_scan_lanes_ref``, the CUDA kernels' order of
operations, is held the same way, and on ragged, decode and reduced
main-path shapes. Inputs are made with numpy from a seed; at bf16 the
same f32 arrays are rounded to bf16 on both sides (round to nearest even
in both, so the bits agree). ``mamba_block`` / ``mamba_decode_step`` are
held against JAX's on reduced hymba-1.5b with converted params: f32 at
1e-4 (XLA and torch sum matmuls in different orders), bf16 at 2e-2.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.config import get_arch as jax_get_arch
from repro.kernels.ssm_scan import ssm_scan as jax_ssm_scan
from repro.kernels.ssm_scan import ssm_scan_ref as jax_ssm_scan_ref
from repro.models import build_model as jax_build_model
from repro.models import ssm as jax_ssm
from repro_torch.config import get_arch
from repro_torch.kernels.ssm_scan import kernel, ssm_scan, ssm_scan_lanes_ref, ssm_scan_ref
from repro_torch.models import ssm
from repro_torch.models.convert import params_from_jax
from repro_torch.models.transformer import layer_slice

F32, BF16 = "float32", "bfloat16"

# B, S, inner, N, chunk (the JAX kernel's), dtype: tests/test_kernels.py SSM_CASES
SSM_CASES = [
    (2, 128, 256, 16, 32, F32),
    (1, 96, 128, 8, 64, F32),     # ragged seq (the JAX wrapper's pad path)
    (2, 64, 512, 16, 16, F32),
    (1, 128, 256, 16, 64, BF16),
]


def y_tol(dtype):
    return dict(atol=2e-2, rtol=2e-2) if dtype == BF16 else dict(atol=2e-5, rtol=2e-5)


H_TOL = dict(atol=1e-4, rtol=1e-4)


def _inputs(B, S, inner, N, seed):
    """f32 numpy arrays with the JAX test's distributions."""
    rng = np.random.RandomState(seed)
    f = lambda *shape: rng.randn(*shape).astype(np.float32)
    u = f(B, S, inner)
    dt = (np.log1p(np.exp(f(B, S, inner))) * 0.1).astype(np.float32)
    return dict(u=u, dt=dt, B_=f(B, S, N), C_=f(B, S, N),
                A=-np.exp(0.5 * f(inner, N)).astype(np.float32), D=f(inner), h0=f(B, inner, N))


def _both(arrs, dtype):
    """(jnp arrays, torch tensors): u, dt, B_, C_ in ``dtype``, the rest f32."""
    low = ("u", "dt", "B_", "C_")
    j = {k: jnp.asarray(v, jnp.dtype(dtype) if k in low else jnp.float32)
         for k, v in arrs.items()}
    t = {k: torch.from_numpy(v).to(getattr(torch, dtype) if k in low else torch.float32)
         for k, v in arrs.items()}
    return j, t


def _np(x):
    return x.float().numpy() if isinstance(x, torch.Tensor) else np.asarray(x, np.float32)


@pytest.mark.parametrize("B,S,inner,N,chunk,dtype", SSM_CASES)
def test_ssm_scan_matches_jax_kernel_and_ref(B, S, inner, N, chunk, dtype):
    j, t = _both(_inputs(B, S, inner, N, seed=S * inner + N), dtype)
    launches = kernel.launches
    y, h = ssm_scan(**t)
    assert kernel.launches == launches          # a CPU tensor never reaches the kernel
    assert y.dtype == t["u"].dtype and h.dtype == torch.float32
    assert tuple(y.shape) == (B, S, inner) and tuple(h.shape) == (B, inner, N)
    jy, jh = jax_ssm_scan(**j, chunk=chunk, interpret=True)
    ry, rh = jax_ssm_scan_ref(**j)
    for ref_y, ref_h in ((jy, jh), (ry, rh)):
        np.testing.assert_allclose(_np(y), _np(ref_y), **y_tol(dtype))
        np.testing.assert_allclose(_np(h), _np(ref_h), **H_TOL)


@pytest.mark.parametrize("dtype", [F32, BF16])
def test_ssm_scan_decode_shape_matches_jax(dtype):
    """S=1 from a carried state, the shape of every decode step."""
    j, t = _both(_inputs(3, 1, 200, 16, seed=1), dtype)
    y, h = ssm_scan(**t)
    ry, rh = jax_ssm_scan_ref(**j)
    np.testing.assert_allclose(_np(y), _np(ry), **y_tol(dtype))
    np.testing.assert_allclose(_np(h), _np(rh), **H_TOL)


def test_ssm_scan_without_h0_starts_from_zeros():
    _, t = _both(_inputs(2, 17, 64, 8, seed=2), F32)
    y, h = ssm_scan(**{**t, "h0": None})
    y0, h0 = ssm_scan(**{**t, "h0": torch.zeros_like(t["h0"])})
    assert torch.equal(y, y0) and torch.equal(h, h0)


def test_ssm_scan_state_carry():
    """A prefill of S steps, then one step from its state, equals a prefill
    of S + 1 steps: the state is all that decode carries."""
    _, t = _both(_inputs(2, 25, 96, 16, seed=3), F32)
    y_all, h_all = ssm_scan(**t)
    head = {k: (v[:, :24] if k in ("u", "dt", "B_", "C_") else v) for k, v in t.items()}
    tail = {k: (v[:, 24:] if k in ("u", "dt", "B_", "C_") else v) for k, v in t.items()}
    y_head, h_head = ssm_scan(**head)
    y_step, h_step = ssm_scan(**{**tail, "h0": h_head})
    np.testing.assert_allclose(y_head.numpy(), y_all[:, :24].numpy(), atol=0, rtol=0)
    np.testing.assert_allclose(y_step.numpy(), y_all[:, 24:].numpy(), **y_tol(F32))
    np.testing.assert_allclose(h_step.numpy(), h_all.numpy(), **H_TOL)


def test_ssm_scan_ref_is_ops_on_cpu():
    """A CPU tensor goes to the plain ``ssm_scan_ref``, never to the kernel
    nor to the kernel-order emulation."""
    _, t = _both(_inputs(1, 9, 32, 8, seed=4), BF16)
    launches = kernel.launches
    y, h = ssm_scan(**t)
    assert kernel.launches == launches
    ry, rh = ssm_scan_ref(**t)
    assert torch.equal(y, ry) and torch.equal(h, rh)
    ly, lh = ssm_scan_lanes_ref(**t)
    assert not torch.equal(lh, rh)      # another order of operations, other bits


def test_kernel_wrapper_refuses_cpu_tensors():
    _, t = _both(_inputs(1, 4, 32, 8, seed=5), F32)
    with pytest.raises(ValueError, match="CUDA"):
        kernel.ssm_scan(**t)


# ---------------------------------------------------------------------------
# the CUDA kernels' order of operations (csrc/ssm_scan.cu)
# ---------------------------------------------------------------------------

# chip_smoke.py's SSM_MAIN_Y_TOL and SSM_MAIN_H_TOL (hymba's main-path shapes)
MAIN_Y_TOL = dict(atol=1e-3, rtol=1e-2)
MAIN_H_TOL = dict(atol=1e-5, rtol=1e-5)


def _hold_lanes(arrs, dtype, y_t, h_t, chunk=None, u_dtype=None):
    """ssm_scan_lanes_ref against the JAX kernel (interpret mode) and the JAX
    ssm_scan_ref on the same inputs (u in ``u_dtype`` if given, dt/B_/C_ in
    ``dtype``)."""
    j, t = _both(arrs, dtype)
    if u_dtype is not None:
        j["u"] = jnp.asarray(arrs["u"], jnp.dtype(u_dtype))
        t["u"] = torch.from_numpy(arrs["u"]).to(getattr(torch, u_dtype))
    y, h = ssm_scan_lanes_ref(**t)
    assert y.dtype == t["u"].dtype and h.dtype == torch.float32
    S = arrs["u"].shape[1]
    refs = [jax_ssm_scan_ref(**j), jax_ssm_scan(**j, chunk=chunk or S, interpret=True)]
    for ref_y, ref_h in refs:
        np.testing.assert_allclose(_np(y), _np(ref_y), **y_t)
        np.testing.assert_allclose(_np(h), _np(ref_h), **h_t)


@pytest.mark.parametrize("B,S,inner,N,chunk,dtype", SSM_CASES)
def test_ssm_scan_lanes_ref_matches_jax_kernel_and_ref(B, S, inner, N, chunk, dtype):
    _hold_lanes(_inputs(B, S, inner, N, seed=S * inner + N), dtype, y_tol(dtype), H_TOL,
                chunk=chunk)


@pytest.mark.parametrize("N", [8, 16])
def test_ssm_scan_lanes_ref_ragged(N):
    """inner 200 is not a multiple of a scan block's channels (32 at N=16,
    64 at N=8), S 33 not a multiple of the 16-step tile."""
    _hold_lanes(_inputs(2, 33, 200, N, seed=N), F32, y_tol(F32), H_TOL, chunk=33)


@pytest.mark.parametrize("N", [8, 16])
@pytest.mark.parametrize("S", [1, 2])
def test_ssm_scan_lanes_ref_decode_from_carried_state(S, N):
    """The decode kernel's shapes: S <= 4 from a carried state."""
    _hold_lanes(_inputs(3, S, 200, N, seed=20 + S), F32, y_tol(F32), H_TOL)


def test_ssm_scan_lanes_ref_reduced_main_path():
    """hymba's main-path types (u bf16; dt, B_, C_ f32; a carried state) at
    a reduced shape, at the card's main-path tolerances."""
    _hold_lanes(_inputs(2, 96, 320, 16, seed=30), F32, MAIN_Y_TOL, MAIN_H_TOL, chunk=32,
                u_dtype=BF16)


# ---------------------------------------------------------------------------
# the Mamba block of reduced hymba-1.5b
# ---------------------------------------------------------------------------

@pytest.fixture(scope="module")
def jax_params():
    cfg = jax_get_arch("hymba-1.5b").reduced()
    return jax.tree_util.tree_map(np.asarray, jax_build_model(cfg).init(jax.random.key(0)))


def _block_pair(dtype, jax_params):
    """(JAX cfg, JAX layer-0 mamba params, port cfg, port layer-0 mamba params)."""
    jcfg = dataclasses.replace(jax_get_arch("hymba-1.5b").reduced(), dtype=dtype)
    cfg = dataclasses.replace(get_arch("hymba-1.5b").reduced(), dtype=dtype)
    jp = jax.tree_util.tree_map(lambda a: jnp.asarray(a[0]), jax_params["blocks"]["mamba"])
    tdtype = torch.bfloat16 if dtype == BF16 else None
    tp = params_from_jax(jax_params, cfg, "cpu", dtype=tdtype)
    return jcfg, jp, cfg, layer_slice(tp["blocks"], 0)["mamba"]


def tol(dtype):
    return dict(atol=2e-2, rtol=2e-2) if dtype == BF16 else dict(atol=1e-4, rtol=1e-4)


@pytest.mark.parametrize("dtype", [F32, BF16])
def test_mamba_block_and_decode_step_match_jax(jax_params, dtype):
    jcfg, jp, cfg, tp = _block_pair(dtype, jax_params)
    rng = np.random.RandomState(11)
    x = rng.randn(2, 21, cfg.d_model).astype(np.float32)     # 21: ragged against chunk 8
    x1 = rng.randn(2, 1, cfg.d_model).astype(np.float32)
    jd, td = jnp.dtype(dtype), getattr(torch, dtype)

    jy, jst = jax.jit(lambda p, xx: jax_ssm.mamba_block(p, xx, jcfg))(jp, jnp.asarray(x, jd))
    ty, tst = ssm.mamba_block(tp, torch.from_numpy(x).to(td), cfg)
    assert ty.dtype == td and tst["h"].dtype == torch.float32 and tst["conv"].dtype == td
    np.testing.assert_allclose(_np(ty), _np(jy), **tol(dtype))
    for key in ("conv", "h"):
        assert tuple(tst[key].shape) == jst[key].shape
        np.testing.assert_allclose(_np(tst[key]), _np(jst[key]), **tol(dtype))

    # one decode step from each side's own state
    jy1, jst1 = jax.jit(lambda p, xx, st: jax_ssm.mamba_decode_step(p, xx, st, jcfg))(
        jp, jnp.asarray(x1, jd), jst)
    ty1, tst1 = ssm.mamba_decode_step(tp, torch.from_numpy(x1).to(td), tst, cfg)
    np.testing.assert_allclose(_np(ty1), _np(jy1), **tol(dtype))
    for key in ("conv", "h"):
        np.testing.assert_allclose(_np(tst1[key]), _np(jst1[key]), **tol(dtype))
