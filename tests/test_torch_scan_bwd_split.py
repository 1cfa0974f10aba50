"""The selective scan's backward split over time, as the CUDA kernels run it
(``csrc/ssm_scan.cu``), emulated on the CPU in plain torch.

The adjoint is linear in the gradient it carries: over a segment of steps
[t_a, t_b) the carry out is g_loc + P * (the carry in), g_loc being the
segment run from a zero carry and P the product of its decays da_t. The
kernels take three steps, in a fixed order, each emulated here:

1. the carry pass: every segment but the first, run in reverse from a zero
   carry, gives (g_loc, P) from dt, A, C_ and dy alone (no state);
2. the fix-up: each segment folds the later segments' (g_loc, P) into its
   carry, the last first, from dh (or zeros);
3. the main pass: each segment, from that carry, walks its 16-step tiles in
   reverse, each tile's states recomputed from the state the forward kept
   before it, and runs the adjoint; dA and dD are summed per (row,
   segment) and those partials summed in order; segment 0 gives dh0.

The emulation lives here only; the package's plain version stays
``ssm_scan_bwd_ref``. It is held against that and against ``jax.grad`` of
the reference's scan oracle (as ``tests/test_torch_hybrid_train.py``
holds ``ssm_scan_bwd_ref``) at 1e-4, on the SSM_CASES rows with and without
h0 and dh, at segment lengths that leave a ragged last segment and a ragged
last tile, and at the segment length the kernel's wrapper picks
(``kernel.bwd_segment``). A mutant that drops P from the fix-up fails.
"""
import numpy as np
import pytest
import torch

from repro_torch.kernels.ssm_scan import kernel, ssm_scan_bwd_ref
from test_torch_hybrid_train import GRAD_TOL, NAMES, SSM_CASES, _bf16, _jax_scan_grads, \
    _scan_inputs, _torch_args

TILE = kernel.TILE


def _kept_states(u, dt, B_, C_, A, h0):
    """The state before each TILE-step tile: h0 (zeros when None), then the
    forward's state after each tile but the last (its ``h_chunks``)."""
    Bb, S, inner = u.shape
    h = torch.zeros((Bb, inner, A.shape[1])) if h0 is None else h0.float()
    kept = [h]
    for t in range(S):
        h = torch.exp(dt[:, t, :, None] * A) * h + \
            dt[:, t, :, None] * B_[:, t, None, :] * u[:, t, :, None]
        if (t + 1) % TILE == 0 and t + 1 < S:
            kept.append(h)
    return kept


def split_bwd(u, dt, B_, C_, A, D, h0, dy, dh, seg: int, with_p: bool = True):
    """The scan's gradient by the kernels' three steps over segments of
    ``seg`` steps (a multiple of TILE); ``with_p=False`` is the mutant that
    folds g_loc alone. Returns (du in u's dtype, ddt, dB_, dC_, dA, dD, dh0
    or None when ``h0`` is None)."""
    assert seg > 0 and seg % TILE == 0
    uf, dyf = u.float(), dy.float()
    Bb, S, inner = u.shape
    N = A.shape[1]
    tiles, seg_tiles = -(-S // TILE), seg // TILE
    NS = kernel.bwd_segments(S, seg)
    da = lambda t: torch.exp(dt[:, t, :, None] * A)                     # (B, inner, N)
    zeros = torch.zeros((Bb, inner, N))

    # 1. the carry pass: (g_loc, P) of every segment but the first
    local = {}
    for s in range(1, NS):
        g, P = zeros.clone(), torch.ones_like(zeros)
        for t in reversed(range(s * seg, min(S, (s + 1) * seg))):
            d = da(t)
            g = (g + C_[:, t, None, :] * dyf[:, t, :, None]) * d
            P = P * d
        local[s] = (g, P)
    # 2. the fix-up: the carry into each segment, the last first
    carry_in = {NS - 1: zeros.clone() if dh is None else dh.float()}
    for s in range(NS - 1, 0, -1):
        g_loc, P = local[s]
        carry_in[s - 1] = g_loc + P * carry_in[s] if with_p else g_loc
    # 3. the main pass, segment by segment, tiles in reverse from the kept states
    kept = _kept_states(uf, dt, B_, C_, A, h0)
    du, ddt, dB, dC = [None] * S, [None] * S, [None] * S, [None] * S
    parts, dh0 = [], None
    for s in range(NS):
        g = carry_in[s].clone()
        gA, gD = zeros.clone(), torch.zeros((Bb, inner))
        for k in reversed(range(s * seg_tiles, min(tiles, (s + 1) * seg_tiles))):
            t0, t1 = k * TILE, min(S, (k + 1) * TILE)
            hs = [kept[k]]
            for t in range(t0, t1):
                hs.append(da(t) * hs[-1] + dt[:, t, :, None] * B_[:, t, None, :] *
                          uf[:, t, :, None])
            for t in reversed(range(t0, t1)):
                prev, h_t, d = hs[t - t0], hs[t - t0 + 1], da(t)
                dtt, ut, dyt = dt[:, t], uf[:, t], dyf[:, t]
                bt, ct = B_[:, t, None, :], C_[:, t, None, :]
                g = g + ct * dyt[..., None]
                dC[t] = torch.einsum("bin,bi->bn", h_t, dyt)
                dB[t] = torch.einsum("bin,bi->bn", g, dtt * ut)
                du[t] = D * dyt + (g * bt).sum(-1) * dtt
                ddt[t] = (g * (A * d * prev + bt * ut[..., None])).sum(-1)
                gA = gA + g * dtt[..., None] * d * prev
                gD = gD + dyt * ut
                g = d * g
        parts.append((gA, gD))
        if s == 0:
            dh0 = g
    # the partials of dA and dD, by (row, segment), summed in that order
    dA, dD = torch.zeros_like(A), torch.zeros_like(D)
    for b in range(Bb):
        for gA, gD in parts:
            dA, dD = dA + gA[b], dD + gD[b]
    stack = lambda xs: torch.stack(xs, dim=1)
    return (stack(du).to(u.dtype), stack(ddt), stack(dB), stack(dC), dA, dD,
            None if h0 is None else dh0)


# (B, S, inner, N): S spans several segments with a ragged last segment and
# a ragged last tile at each of SEGMENTS' lengths
RAGGED_CASES = [
    (2, 75, 40, 16),
    (1, 100, 24, 8),
]
SEGMENTS = (16, 32, 48)


def _case(B, S, inner, N, dtype, with_h0, seed):
    a = _scan_inputs(B, S, inner, N, seed=seed)
    if dtype == "bfloat16":
        a["u"], a["dy"] = _bf16(a["u"]), _bf16(a["dy"])
    t = _torch_args(a, with_h0, dtype)
    args = [t[k] for k in ("u", "dt", "B_", "C_", "A", "D", "h0", "dy", "dh")]
    return a, args


def _hold(got, want, dtype, what):
    """GRAD_TOL, but du at bf16: within half a bf16 ulp of the f32 du of
    jax.grad (an array), within one ulp of the plain version's bf16 du (both
    round an f32 sum to bf16 once, summed in other orders)."""
    for name, g, w in zip(NAMES, got, want):
        if w is None:
            assert g is None, (what, name)
            continue
        ulps = 0.5 if isinstance(w, np.ndarray) else 1.0
        w = w if isinstance(w, np.ndarray) else w.float().numpy()
        tol = dict(atol=1e-6, rtol=ulps * 2 ** -7) if (name == "du" and dtype == "bfloat16") \
            else GRAD_TOL
        np.testing.assert_allclose(g.float().numpy(), w, **tol, err_msg=f"{what} {name}")


@pytest.mark.parametrize("with_h0", [True, False], ids=["h0", "no-h0"])
@pytest.mark.parametrize("case", SSM_CASES, ids=[str(c) for c in SSM_CASES])
def test_split_matches_ref_and_jax_grad(case, with_h0):
    """At the wrapper's segment length and at 32 steps, against the plain
    adjoint and against jax.grad of the reference's scan (du at bf16 as in
    tests/test_torch_hybrid_train.py)."""
    B, S, inner, N, dtype = case
    a, args = _case(B, S, inner, N, dtype, with_h0, seed=S + inner + N)
    want_jax = _jax_scan_grads(a, with_h0)
    want_ref = ssm_scan_bwd_ref(*args)
    for seg in sorted({kernel.bwd_segment(B, S, inner, N), 32}):
        assert kernel.bwd_segments(S, seg) > 1
        got = split_bwd(*args, seg)
        _hold(got, want_ref, dtype, f"seg {seg} vs ssm_scan_bwd_ref")
        _hold(got, want_jax, dtype, f"seg {seg} vs jax.grad")


@pytest.mark.parametrize("seg", SEGMENTS)
@pytest.mark.parametrize("case", RAGGED_CASES, ids=[str(c) for c in RAGGED_CASES])
def test_split_ragged_segments_and_tiles(case, seg):
    B, S, inner, N = case
    assert S % seg and S % TILE
    a, args = _case(B, S, inner, N, "float32", True, seed=3 * S + seg)
    got = split_bwd(*args, seg)
    _hold(got, ssm_scan_bwd_ref(*args), "float32", f"seg {seg}")
    _hold(got, _jax_scan_grads(a, True), "float32", f"seg {seg} vs jax.grad")


def test_one_segment_is_the_whole_walk():
    """A segment longer than S: no carry pass, the walk from dh alone."""
    _, args = _case(2, 40, 24, 16, "float32", True, seed=5)
    _hold(split_bwd(*args, 64), ssm_scan_bwd_ref(*args), "float32", "one segment")


def test_dropping_p_from_the_fix_up_fails():
    """The mutant that folds only g_loc (no decay of the later carry) is
    caught: the carry's part of g is lost at every segment's start."""
    _, args = _case(*RAGGED_CASES[0], "float32", True, seed=11)
    want = ssm_scan_bwd_ref(*args)
    _hold(split_bwd(*args, 32), want, "float32", "with P")
    with pytest.raises(AssertionError):
        _hold(split_bwd(*args, 32, with_p=False), want, "float32", "without P")
