"""The port's plain mLSTM versions against the JAX package's, on the CPU.

``mlstm_ref`` (the sequential oracle of the CUDA kernel) and
``mlstm_chunkwise_ref`` (the chunkwise form the model runs on the CPU) are
held against the JAX ``mlstm_ref`` and the Pallas ``mlstm_chunkwise`` in
interpret mode on the MLSTM_CASES rows of ``tests/test_kernels.py``
(copied): h at that test's tolerance (2e-5 f32, 2e-2 bf16), m at its 1e-3,
and the f32 state C, n at 1e-4. Against ``repro.models.xlstm._mlstm_scan``
(the model's scan) they start from a nonzero state at a ragged S. Inputs
are made with numpy from a seed; at bf16 the same f32 arrays are rounded to
bf16 on both sides (round to nearest even in both, so the bits agree).
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels.mlstm import mlstm_chunkwise as jax_mlstm_chunkwise
from repro.kernels.mlstm import mlstm_ref as jax_mlstm_ref
from repro.models import xlstm as jax_xlstm
from repro_torch.kernels.mlstm import (kernel, mlstm, mlstm_chunkwise_hilo_ref,
                                       mlstm_chunkwise_ref, mlstm_ref, mlstm_step_ref)

F32, BF16 = "float32", "bfloat16"

# B, H, S, hd, chunk (the JAX kernel's), dtype: tests/test_kernels.py MLSTM_CASES
MLSTM_CASES = [
    (2, 2, 128, 64, 32, F32),
    (1, 4, 64, 32, 64, F32),     # single chunk
    (2, 1, 96, 128, 16, F32),    # hd 128, odd chunk count
    (1, 2, 128, 64, 64, BF16),
]

M_TOL = dict(atol=1e-3, rtol=1e-3)
STATE_TOL = dict(atol=1e-4, rtol=1e-4)


def h_tol(dtype):
    return dict(atol=2e-2, rtol=2e-2) if dtype == BF16 else dict(atol=2e-5, rtol=2e-5)


def _np(x):
    return x.float().numpy() if isinstance(x, torch.Tensor) else np.asarray(x, np.float32)


def _inputs(B, H, S, hd, seed, with_state=False):
    """f32 numpy arrays in the JAX kernel's layout: q, k, v (B,H,S,hd) normal,
    gates (B,H,S,2) 2 x normal, and a state (C, n normal, m 0.5 x normal)."""
    rng = np.random.RandomState(seed)
    f = lambda *shape: rng.randn(*shape).astype(np.float32)
    arrs = dict(q=f(B, H, S, hd), k=f(B, H, S, hd), v=f(B, H, S, hd), g=2 * f(B, H, S, 2))
    if with_state:
        arrs["state"] = (f(B, H, hd, hd), f(B, H, hd), 0.5 * f(B, H))
    return arrs


def _jax(a, dtype):
    return (*(jnp.asarray(a[x], jnp.dtype(dtype)) for x in "qkv"), jnp.asarray(a["g"], dtype))


def _torch(a, dtype):
    td = getattr(torch, dtype)
    return (*(torch.from_numpy(a[x]).to(td) for x in "qkv"), torch.from_numpy(a["g"]).to(td))


def _model_layout(q, k, v, g):
    """(B,H,S,hd) / (B,H,S,2) -> the model's (B,S,H,hd) / (B,S,2H) f32 gates."""
    gm = torch.cat([g[..., 0], g[..., 1]], dim=1).transpose(1, 2).float()
    return q.transpose(1, 2), k.transpose(1, 2), v.transpose(1, 2), gm


def _assert_state(st, ref, m_tol=M_TOL):
    for name, a, b in zip("Cn", st[:2], ref[:2]):
        assert a.dtype == torch.float32, name
        np.testing.assert_allclose(_np(a), _np(b), err_msg=name, **STATE_TOL)
    np.testing.assert_allclose(_np(st[2]), _np(ref[2]), err_msg="m", **m_tol)


@pytest.mark.parametrize("B,H,S,hd,chunk,dtype", MLSTM_CASES)
def test_mlstm_ref_matches_jax(B, H, S, hd, chunk, dtype):
    a = _inputs(B, H, S, hd, seed=S * hd + chunk)
    h, st = mlstm_ref(*_torch(a, dtype))
    jh, jst = jax_mlstm_ref(*_jax(a, dtype))
    assert h.dtype == getattr(torch, dtype) and tuple(h.shape) == (B, H, S, hd)
    np.testing.assert_allclose(_np(h), _np(jh), **h_tol(dtype))
    _assert_state(st, jst)


@pytest.mark.parametrize("B,H,S,hd,chunk,dtype", MLSTM_CASES)
def test_mlstm_chunkwise_ref_matches_jax_kernel_and_ref(B, H, S, hd, chunk, dtype):
    a = _inputs(B, H, S, hd, seed=S * hd + chunk)
    h, st = mlstm_chunkwise_ref(*_model_layout(*_torch(a, dtype)), chunk=chunk)
    assert h.dtype == getattr(torch, dtype) and tuple(h.shape) == (B, S, H, hd)
    jh, jst = jax_mlstm_chunkwise(*_jax(a, dtype), chunk=chunk, interpret=True)
    rh, rst = jax_mlstm_ref(*_jax(a, dtype))
    for ref_h, ref_st in ((jh, jst), (rh, rst)):
        np.testing.assert_allclose(_np(h.transpose(1, 2)), _np(ref_h), **h_tol(dtype))
        _assert_state(st, ref_st)


@pytest.mark.parametrize("which", ["sequential", "chunkwise"])
def test_mlstm_state_carry_composes(which):
    """Running two halves with the state carried == running them jointly
    (the JAX test's case, B1 H2 S64 hd32, for each plain version)."""
    q, k, v, g = _torch(_inputs(1, 2, 64, 32, seed=0), F32)
    if which == "sequential":
        run = lambda sl, st=None: mlstm_ref(q[:, :, sl], k[:, :, sl], v[:, :, sl], g[:, :, sl], st)
    else:
        qm, km, vm, gm = _model_layout(q, k, v, g)
        run = lambda sl, st=None: mlstm_chunkwise_ref(qm[:, sl], km[:, sl], vm[:, sl],
                                                      gm[:, sl], st, chunk=16)
    _, joint = run(slice(0, 64))
    _, st = run(slice(0, 32))
    _, split = run(slice(32, 64), st)
    for a, b in zip(joint, split):
        np.testing.assert_allclose(_np(a), _np(b), atol=1e-5, rtol=1e-5)


@pytest.mark.parametrize("S", [12, 16, 1])
def test_mlstm_from_state_matches_jax_model_scan(S):
    """A nonzero initial state; S=12 is ragged against chunk 8 (the JAX scan
    falls back to chunk 1, the port pads), S=1 is a decode step."""
    a = _inputs(2, 4, S, 64, seed=100 + S, with_state=True)
    qm, km, vm, gm = _model_layout(*_torch(a, F32))
    state = tuple(torch.from_numpy(x) for x in a["state"])
    h, st = mlstm_chunkwise_ref(qm, km, vm, gm, state, chunk=8)
    jstate = {key: jnp.asarray(x) for key, x in zip("Cnm", a["state"])}
    jh, jst = jax_xlstm._mlstm_scan(*(jnp.asarray(_np(x)) for x in (qm, km, vm, gm)),
                                    jstate, 8)
    np.testing.assert_allclose(_np(h), _np(jh), **h_tol(F32))
    _assert_state(st, (jst["C"], jst["n"], jst["m"]))
    sh, sst = mlstm_ref(*_torch(a, F32), state)
    np.testing.assert_allclose(_np(sh.transpose(1, 2)), _np(jh), **h_tol(F32))
    _assert_state(sst, (jst["C"], jst["n"], jst["m"]))


def test_mlstm_chunk_length_changes_only_rounding():
    """Chunk 8 and chunk 1 (the sequential order) give the same h and state."""
    a = _inputs(2, 2, 40, 32, seed=7, with_state=True)
    args = _model_layout(*_torch(a, F32))
    state = tuple(torch.from_numpy(x) for x in a["state"])
    h8, st8 = mlstm_chunkwise_ref(*args, state, chunk=8)
    h1, st1 = mlstm_chunkwise_ref(*args, state, chunk=1)
    np.testing.assert_allclose(_np(h8), _np(h1), **h_tol(F32))
    _assert_state(st8, st1)


def test_mlstm_ops_runs_the_plain_version_on_cpu():
    """A CPU tensor goes to ``mlstm_chunkwise_ref`` and never to the kernel."""
    a = _inputs(1, 2, 20, 32, seed=3, with_state=True)
    args = _model_layout(*_torch(a, BF16))
    state = tuple(torch.from_numpy(x) for x in a["state"])
    counts = lambda: (kernel.launches_tc, kernel.launches_tf32, kernel.launches_step)
    launches = counts()
    h, st = mlstm(*args, state, chunk=8)
    assert counts() == launches
    rh, rst = mlstm_chunkwise_ref(*args, state, chunk=8)
    assert torch.equal(h, rh) and all(torch.equal(x, y) for x, y in zip(st, rst))


def test_kernel_wrapper_refuses_cpu_tensors():
    args = _model_layout(*_torch(_inputs(1, 2, 4, 32, seed=5), F32))
    with pytest.raises(ValueError, match="CUDA"):
        kernel.mlstm(*args)


def test_tensor_core_wrapper_refuses_cpu_tensors():
    args = _model_layout(*_torch(_inputs(1, 2, 16, 64, seed=5), BF16))
    with pytest.raises(ValueError, match="CUDA"):
        kernel.mlstm_tc(*args)


@pytest.mark.parametrize("dtype,S", [(BF16, 16), (F32, 16)])
def test_prefill_wrappers_refuse_cpu_tensors(dtype, S):
    """A prefill (S > STEP_MAX) through the dispatching ``kernel.mlstm`` and
    through the split-TF32 wrapper raises on CPU tensors, whichever kernel it
    picks."""
    args = _model_layout(*_torch(_inputs(1, 2, S, 64, seed=5), dtype))
    for fn in (kernel.mlstm, kernel.mlstm_tf32):
        with pytest.raises(ValueError, match="CUDA"):
            fn(*args)


def _misaligned(t):
    """A copy of ``t`` whose data starts 2 bytes past a 16-byte boundary."""
    flat = torch.zeros(t.numel() + 8, dtype=t.dtype)
    flat[1:1 + t.numel()] = t.reshape(-1)
    return flat[1:1 + t.numel()].view(t.shape)


@pytest.mark.parametrize("dtype,hd,misaligned,takes", [
    (BF16, 64, False, True), (BF16, 512, False, True),     # xlstm-350m's hd 512
    (BF16, 96, False, False), (F32, 64, False, False), (BF16, 64, True, False)])
def test_prefill_route_takes_bf16_head_dims_multiple_of_64(dtype, hd, misaligned, takes):
    """``kernel.mlstm`` sends a bf16 prefill to the tensor-core kernel when
    the head dim is a multiple of 64 and q/k/v meet TMA's alignment; f32,
    other head dims and misaligned inputs take the split-TF32 kernel."""
    q, k, v, _ = _model_layout(*_torch(_inputs(1, 2, 16, hd, seed=8), dtype))
    if misaligned:
        q = _misaligned(q)
    assert kernel._tc_takes(q, k, v) is takes


# ---------------------------------------------------------------------------
# the CUDA kernels' algorithms, as plain forms: the one-pass decode step and
# the tensor-core prefill's rounding scheme (hi + lo bf16 halves)
# ---------------------------------------------------------------------------

STEP_TOL = dict(atol=1e-5, rtol=1e-5)


@pytest.mark.parametrize("B,H,hd,S", [(2, 2, 64, 1), (1, 4, 32, 1), (2, 1, 128, 1),
                                      (8, 4, 128, 1), (1, 2, 64, 3)])
def test_mlstm_step_ref_matches_jax_from_state(B, H, hd, S):
    """The decode step's one-pass form from a carried state, against the JAX
    sequential oracle, f32 at 1e-5 (h, C, n and m)."""
    a = _inputs(B, H, S, hd, seed=200 + hd + S, with_state=True)
    state = tuple(torch.from_numpy(x) for x in a["state"])
    h, st = mlstm_step_ref(*_model_layout(*_torch(a, F32)), state)
    jh, jst = jax_mlstm_ref(*_jax(a, F32), tuple(jnp.asarray(x) for x in a["state"]))
    assert h.dtype == torch.float32 and tuple(h.shape) == (B, S, H, hd)
    np.testing.assert_allclose(_np(h.transpose(1, 2)), _np(jh), **STEP_TOL)
    for name, x, y in zip("Cnm", st, jst):
        np.testing.assert_allclose(_np(x), _np(y), err_msg=name, **STEP_TOL)


def test_mlstm_step_ref_from_zero_state_matches_sequential():
    a = _inputs(2, 2, 2, 64, seed=11)
    args = _model_layout(*_torch(a, F32))
    h, st = mlstm_step_ref(*args)
    rh, rst = mlstm_ref(*_torch(a, F32))
    np.testing.assert_allclose(_np(h.transpose(1, 2)), _np(rh), **STEP_TOL)
    for x, y in zip(st, rst):
        np.testing.assert_allclose(_np(x), _np(y), **STEP_TOL)


# chip_smoke.py's tolerances: the oracle cases' state (MLSTM_STATE_TOL) and
# the prefill shape's against the plain chunkwise form (MLSTM_MAIN_*)
MAIN_H_TOL = dict(atol=1e-3, rtol=1e-2)
MAIN_STATE_TOL = dict(atol=1e-4, rtol=1e-3)


@pytest.mark.parametrize("B,H,S,hd,chunk,dtype",
                         [c for c in MLSTM_CASES if c[-1] == BF16]
                         + [(2, 2, 100, 64, 64, BF16), (1, 1, 200, 128, 64, BF16)])
@pytest.mark.parametrize("with_state", [False, True])
def test_mlstm_hilo_emulation_matches_jax_ref(B, H, S, hd, chunk, dtype, with_state):
    """The tensor-core kernel's rounding scheme (its chunk of 64, hi + lo
    halves of P', C_in and V w) against the JAX sequential oracle on the
    bf16 MLSTM_CASES row and ragged S with and without a carried state:
    h at the bf16 tolerance, C and n at 1e-4, m at 1e-3."""
    a = _inputs(B, H, S, hd, seed=300 + S + hd, with_state=with_state)
    state = tuple(torch.from_numpy(x) for x in a["state"]) if with_state else None
    h, st = mlstm_chunkwise_hilo_ref(*_model_layout(*_torch(a, dtype)), state)
    jstate = tuple(jnp.asarray(x) for x in a["state"]) if with_state else None
    jh, jst = jax_mlstm_ref(*_jax(a, dtype), jstate)
    assert h.dtype == torch.bfloat16
    np.testing.assert_allclose(_np(h.transpose(1, 2)), _np(jh), **h_tol(dtype))
    _assert_state(st, jst)


def test_mlstm_hilo_emulation_holds_main_tolerances():
    """At the model's head_dim (512) over 16 chunks, the emulation stays within
    chip_smoke.py's prefill-shape tolerances of the plain chunkwise form at
    the model's chunk 256, and of the JAX oracle."""
    a = _inputs(1, 2, 1024, 512, seed=9)
    args = _model_layout(*_torch(a, BF16))
    h, st = mlstm_chunkwise_hilo_ref(*args)
    rh, rst = mlstm_chunkwise_ref(*args, chunk=256)
    np.testing.assert_allclose(_np(h), _np(rh), **MAIN_H_TOL)
    for name, x, y in zip("Cn", st[:2], rst[:2]):
        np.testing.assert_allclose(_np(x), _np(y), err_msg=name, **MAIN_STATE_TOL)
    np.testing.assert_allclose(_np(st[2]), _np(rst[2]), **M_TOL)


def _main_shape_errors_with(split):
    """The emulation at the model's head_dim with ``ref._hilo`` replaced by
    ``split``; whether h, C and n hold chip_smoke.py's prefill-shape
    tolerances against the plain chunkwise form at chunk 256."""
    from unittest import mock

    from repro_torch.kernels.mlstm import ref

    a = _inputs(1, 2, 1024, 512, seed=9)
    args = _model_layout(*_torch(a, BF16))
    rh, rst = mlstm_chunkwise_ref(*args, chunk=256)
    with mock.patch.object(ref, "_hilo", split):
        h, st = mlstm_chunkwise_hilo_ref(*args)
    close = lambda x, y, t: bool(torch.all((x.float() - y.float()).abs()
                                           <= t["atol"] + t["rtol"] * y.float().abs()))
    return (close(h, rh, MAIN_H_TOL), close(st[0], rst[0], MAIN_STATE_TOL),
            close(st[1], rst[1], MAIN_STATE_TOL))


def test_mlstm_one_rounding_misses_main_tolerances():
    """Why the kernel splits f32 operands: with C_in, P' and V·w each rounded
    to bf16 once, h and C miss the prefill-shape tolerances that the hi + lo
    scheme holds (test above)."""
    once = lambda x, terms=2: (x.to(torch.bfloat16).float(),)
    h_ok, C_ok, _ = _main_shape_errors_with(once)
    assert not h_ok and not C_ok


def test_mlstm_hi_only_inter_is_caught_at_the_main_h_tolerance():
    """The kernel's q·C_inᵀ taken from C_in's hi half alone leaves the state
    exact but moves h past the prefill-shape tolerance, so chip_smoke.py's
    main-path check catches that fault."""
    from repro_torch.kernels.mlstm import ref

    full = ref._hilo

    def hi_only_for_C(x, terms=2):
        if x.dim() == 4 and x.shape[-1] == x.shape[-2] == 512:   # C_in (B, H, hd, hd)
            return (x.to(torch.bfloat16).float(),)
        return full(x, terms)

    h_ok, C_ok, n_ok = _main_shape_errors_with(hi_only_for_C)
    assert not h_ok and C_ok and n_ok
