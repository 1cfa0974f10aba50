"""The tensor-core mLSTM's split design, as its plain form, on the CPU.

``mlstm_chunkwise_split_ref`` is what ``csrc/mlstm_tc.cu``'s carry pass and
output pass compute: C carried tile by tile through the chunks with the
kernel's hi + lo rounding, each chunk's h from the C_in, n_in and m_in the
carry kept. It is held against the JAX package (the Pallas
``mlstm_chunkwise`` in interpret mode on the MLSTM_CASES rows of
``tests/test_kernels.py``, the sequential ``mlstm_ref`` from a carried
state at a ragged S), against ``mlstm_chunkwise_hilo_ref`` (the single
pass's rounding) on h, the final state and every kept tensor, and against
the sequential recurrence's state at each chunk's start. The kernel takes
bf16 q/k/v only, so every case runs in bf16 on both sides. A carry that
drops V·w's lo half misses the prefill-shape tolerances that
``chip_smoke.py`` holds the kernel to. Last, the wrapper's rule that picks
the design by shape, and its plumbing on the meta device (no card).
"""
from unittest import mock

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels.mlstm import mlstm_chunkwise as jax_mlstm_chunkwise
from repro.kernels.mlstm import mlstm_ref as jax_mlstm_ref
from repro_torch.kernels.mlstm import (kernel, mlstm_chunkwise_hilo_ref, mlstm_chunkwise_ref,
                                       mlstm_chunkwise_split_ref, mlstm_ref)

# B, H, S, hd, chunk (the JAX kernel's): tests/test_kernels.py MLSTM_CASES
MLSTM_CASES = [
    (2, 2, 128, 64, 32),
    (1, 4, 64, 32, 64),      # single chunk
    (2, 1, 96, 128, 16),     # hd 128, odd chunk count
    (1, 2, 128, 64, 64),
]

H_TOL = dict(atol=2e-2, rtol=2e-2)     # bf16 h, as tests/test_kernels.py
M_TOL = dict(atol=1e-3, rtol=1e-3)
STATE_TOL = dict(atol=1e-4, rtol=1e-4)
# chip_smoke.py's prefill-shape tolerances (MLSTM_MAIN_H_TOL, MLSTM_MAIN_STATE_TOL)
MAIN_H_TOL = dict(atol=1e-3, rtol=1e-2)
MAIN_STATE_TOL = dict(atol=1e-4, rtol=1e-3)


@pytest.fixture(autouse=True)
def one_thread():
    """Keep torch on one thread: the test workers share the machine's cores."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


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


def _jax(a):
    """q, k, v in bf16 and the gates in f32, the JAX kernel's layout."""
    return (*(jnp.asarray(a[x], jnp.bfloat16) for x in "qkv"), jnp.asarray(a["g"]))


def _model(a):
    """The same inputs in the model's layout: q, k, v (B,S,H,hd) bf16 (rounded
    to nearest even as jnp rounds them), gates (B,S,2H) f32."""
    qkv = (torch.from_numpy(a[x]).to(torch.bfloat16).transpose(1, 2) for x in "qkv")
    g = torch.from_numpy(a["g"])
    return (*qkv, torch.cat([g[..., 0], g[..., 1]], dim=1).transpose(1, 2))


def _state(a):
    return tuple(torch.from_numpy(x) for x in a["state"]) if "state" in a else None


def _close(x, y, t, name=""):
    np.testing.assert_allclose(_np(x), _np(y), err_msg=name, **t)


def _assert_state(st, ref):
    for name, x, y in zip("Cn", st[:2], ref[:2]):
        assert x.dtype == torch.float32, name
        _close(x, y, STATE_TOL, name)
    _close(st[2], ref[2], M_TOL, "m")


@pytest.mark.parametrize("B,H,S,hd,chunk", MLSTM_CASES)
def test_split_ref_matches_jax_kernel_and_ref(B, H, S, hd, chunk):
    """h at the bf16 tolerance, C and n at 1e-4, m at 1e-3, against the
    Pallas kernel in interpret mode and the JAX sequential oracle."""
    if hd % 64:
        tile = 32          # the kernel takes hd % 64 == 0; the form itself any tile
    else:
        tile = 64
    a = _inputs(B, H, S, hd, seed=S * hd + chunk)
    h, st, kept = mlstm_chunkwise_split_ref(*_model(a), tile=tile)
    assert h.dtype == torch.bfloat16 and tuple(h.shape) == (B, S, H, hd)
    jh, jst = jax_mlstm_chunkwise(*_jax(a), chunk=chunk, interpret=True)
    rh, rst = jax_mlstm_ref(*_jax(a))
    for ref_h, ref_st in ((jh, jst), (rh, rst)):
        _close(h.transpose(1, 2), ref_h, H_TOL, "h")
        _assert_state(st, ref_st)


@pytest.mark.parametrize("B,H,S,hd", [(2, 2, 100, 64), (1, 1, 200, 128)])
def test_split_ref_from_state_ragged_matches_jax_ref(B, H, S, hd):
    """A carried start state at a ragged S (the last chunk 36 or 8 steps)."""
    a = _inputs(B, H, S, hd, seed=400 + S + hd, with_state=True)
    h, st, _ = mlstm_chunkwise_split_ref(*_model(a), _state(a))
    jh, jst = jax_mlstm_ref(*_jax(a), tuple(jnp.asarray(x) for x in a["state"]))
    _close(h.transpose(1, 2), jh, H_TOL, "h")
    _assert_state(st, jst)


def _sequential_n_dot_q(q, k, gates, state):
    """n_t·q_t of the sequential recurrence (``mlstm_ref``'s n), (B, S, H)."""
    B, S, H, hd = q.shape
    n = state[1].clone() if state is not None else torch.zeros((B, H, hd))
    m = state[2].clone() if state is not None else torch.zeros((B, H))
    out = []
    for t in range(S):
        it, ft = gates[:, t, :H], gates[:, t, H:]
        m_new = torch.maximum(ft + m, it)
        n = torch.exp(ft + m - m_new)[..., None] * n + torch.exp(it - m_new)[..., None] * (
            k[:, t].float() / hd ** 0.5)
        out.append((n * q[:, t].float()).sum(-1))
        m = m_new
    return torch.stack(out, dim=1)


@pytest.mark.parametrize("S,with_state", [(200, True), (256, False), (100, True)])
def test_split_ref_equals_hilo_emulation_and_keeps_the_chunk_starts(S, with_state):
    """h, the final state and every kept tensor against the single pass's
    rounding (``mlstm_chunkwise_hilo_ref``: C_in of chunk c is its final
    state after 64 c steps) and against the sequential recurrence: C_in,
    n_in, m_in = ``mlstm_ref``'s state after 64 c steps at the state
    tolerance, n_t·q_t = its n_t·q_t."""
    B, H, hd = 2, 2, 128
    a = _inputs(B, H, S, hd, seed=500 + S, with_state=with_state)
    args, state = _model(a), _state(a)
    h, st, (kC, kn, km, knq) = mlstm_chunkwise_split_ref(*args, state)
    nc = -(-S // kernel.CHUNK)
    assert [tuple(t.shape) for t in (kC, kn, km, knq)] == [
        (B, H, nc, hd, hd), (B, H, nc, hd), (B, H, nc), (B, S, H)]
    assert all(t.dtype == torch.float32 for t in (kC, kn, km, knq))
    hh, hst = mlstm_chunkwise_hilo_ref(*args, state)
    _close(h, hh, MAIN_H_TOL, "h")
    _assert_state(st, hst)
    q, k, v, g = args
    to_ref = lambda x: x.transpose(1, 2)
    g_ref = torch.stack([g[..., :H], g[..., H:]], dim=-1).transpose(1, 2)
    for ci in range(nc):
        t = ci * kernel.CHUNK
        if t == 0:
            want = state if state is not None else (torch.zeros_like(kC[:, :, 0]),
                                                    torch.zeros_like(kn[:, :, 0]),
                                                    torch.zeros_like(km[:, :, 0]))
            hilo = want
        else:
            _, want = mlstm_ref(to_ref(q[:, :t]), to_ref(k[:, :t]), to_ref(v[:, :t]),
                                g_ref[:, :, :t], state)
            _, hilo = mlstm_chunkwise_hilo_ref(q[:, :t], k[:, :t], v[:, :t], g[:, :t], state)
        got = (kC[:, :, ci], kn[:, :, ci], km[:, :, ci])
        _assert_state(got, want)
        _assert_state(got, hilo)
    _close(knq, _sequential_n_dot_q(q, k, g, state), STATE_TOL, "n.q")


def _main_shape_errors(patch=None):
    """The split form at the model's head_dim (512) over 16 chunks, ``ref._hilo``
    replaced by ``patch`` where given; whether h, C and n hold chip_smoke.py's
    prefill-shape tolerances against the plain chunkwise form at chunk 256."""
    from repro_torch.kernels.mlstm import ref

    a = _inputs(1, 2, 1024, 512, seed=9)
    args = _model(a)
    rh, rst = mlstm_chunkwise_ref(*args, chunk=256)
    with mock.patch.object(ref, "_hilo", patch or ref._hilo):
        h, st, _ = mlstm_chunkwise_split_ref(*args)
    close = lambda x, y, t: bool(torch.all((x.float() - y.float()).abs()
                                           <= t["atol"] + t["rtol"] * y.float().abs()))
    return (close(h, rh, MAIN_H_TOL), close(st[0], rst[0], MAIN_STATE_TOL),
            close(st[1], rst[1], MAIN_STATE_TOL))


def test_split_ref_holds_main_tolerances():
    assert _main_shape_errors() == (True, True, True)


def test_split_carry_without_vw_lo_half_misses_main_tolerances():
    """The mutant: the carry's V·w taken as its hi half alone (one bf16
    rounding of each term of C's update) moves h and C past the
    prefill-shape tolerances; n, on FMAs in f32, stays."""
    from repro_torch.kernels.mlstm import ref

    full = ref._hilo

    def vw_hi_only(x, terms=2):
        if terms == 2 and x.dim() == 4 and x.shape[1] == kernel.CHUNK and x.shape[2] == 2:
            return (x.to(torch.bfloat16).float(),)   # V·w (B, chunk, H, tile)
        return full(x, terms)

    h_ok, C_ok, n_ok = _main_shape_errors(vw_hi_only)
    assert not h_ok and not C_ok and n_ok


# ---------------------------------------------------------------------------
# the wrapper: which design takes a shape, and its plumbing (meta device)
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("B,S,H,hd,design", [
    (1, 4096, 4, 512, "split"),      # xlstm-350m's training microbatch: 32 single-pass blocks
    (8, 4096, 4, 512, "single"),     # its serving prefill: 256
    (3, 4096, 4, 512, "split"),      # 96 (measured: split 0.893 ms, single 1.033)
    (4, 4096, 4, 512, "single"),     # 128 (split 1.203, single 1.013)
    (2, 4096, 4, 512, "split"),
    (1, 100, 2, 64, "split"),
])
def test_tc_design_by_shape(B, S, H, hd, design):
    assert kernel.tc_design(B, S, H, hd) == design
    assert (kernel.tc_design(B, S, H, hd) == "split") == (
        (hd // 64) * B * H < kernel.TC_SPLIT_BELOW)


@pytest.mark.parametrize("design", ["split", "single"])
@pytest.mark.parametrize("keep", [False, True])
def test_tc_call_shapes_on_meta(design, keep):
    """Either design through ``tc_call`` on meta tensors: outputs and kept
    tensors of the kernel's shapes and dtypes, nothing launched or counted."""
    B, S, H, hd = 2, 100, 2, 64
    meta = lambda *shape, dtype=torch.bfloat16: torch.empty(shape, dtype=dtype, device="meta")
    q, k, v = (meta(B, S, H, hd) for _ in range(3))
    gates = meta(B, S, 2 * H, dtype=torch.float32)
    launches = kernel.launches_tc
    out = kernel.tc_call(design, q, k, v, gates, keep=keep)
    assert kernel.launches_tc == launches
    assert len(out) == (3 if keep else 2)
    h, (C, n, m) = out[:2]
    assert h.shape == q.shape and h.dtype == torch.bfloat16
    assert [tuple(t.shape) for t in (C, n, m)] == [(B, H, hd, hd), (B, H, hd), (B, H)]
    if keep:
        assert [tuple(t.shape) for t in out[2]] == [(B, H, 2, hd, hd), (B, H, 2, hd), (B, H, 2),
                                                    (B, S, H)]


def test_tc_call_refuses_an_unknown_design_and_cpu_tensors():
    a = _inputs(1, 2, 16, 64, seed=5)
    args = _model(a)
    with pytest.raises(ValueError, match="design"):
        kernel.tc_call("fast", *args)
    for design in ("split", "single"):
        with pytest.raises(ValueError, match="CUDA"):
            kernel.tc_call(design, *args)
