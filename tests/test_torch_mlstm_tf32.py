"""The arithmetic of the split-TF32 chunkwise mLSTM kernel
(``mlstm_tf32_kernel``, csrc/mlstm.cu), emulated on the CPU: chunks of 64
timesteps, every product (q K^T, q C_in^T, (V w)^T K and P' V) as split TF32
(3xTF32, the helpers of ``tests/test_torch_flash_bwd_tf32.py``). Each
32-column slice's share of P and of inter is taken from zero and joined to
its running sum by an f32 add; (V w)^T K over the chunk's 64 steps is taken
from zero and joined to C in f32; n, n.q and the chunk's scalars are f32.

The emulation lives here only; the package's plain version stays
``mlstm_chunkwise_ref``. It is held against the JAX package's Pallas
``mlstm_chunkwise`` in interpret mode on the f32 rows of
``tests/test_kernels.py`` MLSTM_CASES, against the JAX sequential oracle at
a ragged S with a carried state, and against an f64 sequential recurrence
at B1 H1 S1024 hd512 (xlstm-350m's head dim), at ``chip_smoke.py``'s
tolerances: h at F32_TOL, C and n at MLSTM_STATE_TOL, m at MLSTM_M_TOL, and
h, C, n at MLSTM_MAIN_STATE_TOL at the longer shape. One TF32 product per
product, without the split, misses them.

    PYTHONPATH=src python tests/test_torch_mlstm_tf32.py

prints, at those shapes, the worst error of the split, of plain f32 and of
one TF32 product as a fraction of each tolerance's limit.
"""
import math

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels.mlstm import mlstm_chunkwise as jax_mlstm_chunkwise
from repro.kernels.mlstm import mlstm_ref as jax_mlstm_ref
from repro_torch.kernels.mlstm import mlstm_chunkwise_ref
from test_torch_flash_bwd_tf32 import mm_f32, mm_split, mm_tf32, rna, split
from test_torch_mlstm import _inputs, _jax, _model_layout, _torch

CH, KS = 64, 32                        # csrc/mlstm.cu: timesteps a chunk, key columns a slice
NEG_INF = -1e30                        # csrc/common.cuh's masking value
# chip_smoke.py's tolerances
F32_TOL = dict(atol=2e-5, rtol=2e-5)
MLSTM_STATE_TOL = dict(atol=1e-4, rtol=1e-4)
MLSTM_M_TOL = dict(atol=1e-3, rtol=1e-3)
MLSTM_MAIN_STATE_TOL = dict(atol=1e-4, rtol=1e-3)
TOLS = dict(h=F32_TOL, C=MLSTM_STATE_TOL, n=MLSTM_STATE_TOL, m=MLSTM_M_TOL)
MAIN_TOLS = dict(h=MLSTM_MAIN_STATE_TOL, C=MLSTM_MAIN_STATE_TOL, n=MLSTM_MAIN_STATE_TOL,
                 m=MLSTM_M_TOL)

# (B, H, S, hd, chunk): the f32 rows of tests/test_kernels.py MLSTM_CASES
# (chunk is the JAX kernel's; the emulation takes the CUDA kernel's 64)
JAX_CASES = [
    (2, 2, 128, 64, 32),
    (1, 4, 64, 32, 64),
    (2, 1, 96, 128, 16),
]
F64_CASE = (1, 1, 1024, 512)           # (B, H, S, hd)


def chunkwise(q, k, v, gates, state=None, mm=mm_split):
    """(h (B, S, H, hd), (C, n, m)) by the kernel's chunkwise form in f32,
    every product taken by ``mm``; q, k, v (B, S, H, hd), gates (B, S, 2H)
    f32, state (C, n, m) or None for zeros. A ragged S is padded to whole
    chunks with zero q/k/v and gates i~ = NEG_INF, f~ = 0 (the kernel's zero
    fill and masked gates)."""
    B, S, H, hd = q.shape
    heads = lambda t: t.float().transpose(1, 2)                 # (B, H, S, hd)
    qh, kh, vh = heads(q), heads(k), heads(v)
    ig, fg = gates[..., :H].float().transpose(1, 2), gates[..., H:].float().transpose(1, 2)
    pad = (-S) % CH
    if pad:
        qh, kh, vh = (torch.nn.functional.pad(t, (0, 0, 0, pad)) for t in (qh, kh, vh))
        ig = torch.nn.functional.pad(ig, (0, pad), value=NEG_INF)
        fg = torch.nn.functional.pad(fg, (0, pad))
    if state is None:
        C = torch.zeros((B, H, hd, hd))
        n, m = torch.zeros((B, H, hd)), torch.zeros((B, H))
    else:
        C, n, m = (t.float().clone() for t in state)
    inv = torch.tensor(1.0 / math.sqrt(hd), dtype=torch.float32)
    causal = torch.tril(torch.ones((CH, CH), dtype=torch.bool))
    hs = []
    for t0 in range(0, S + pad, CH):
        qc, kc, vc = qh[:, :, t0:t0 + CH], kh[:, :, t0:t0 + CH], vh[:, :, t0:t0 + CH]
        b = torch.cumsum(fg[:, :, t0:t0 + CH], dim=-1)           # (B, H, CH)
        a = ig[:, :, t0:t0 + CH] - b
        M = torch.maximum(m[..., None], torch.cummax(a, dim=-1).values)
        last = min(CH, S - t0) - 1
        M_c, b_c = M[..., last], b[..., last]
        cw = torch.exp(m[..., None] - M)                          # (B, H, CH)
        w = torch.exp(a - M_c[..., None]) * inv
        cscale = torch.exp(m - M_c)
        # P and inter: a share per slice of 32 key columns, from zero, joined in f32
        P = torch.zeros((B, H, CH, CH))
        inter = torch.zeros((B, H, CH, hd))
        for c0 in range(0, hd, KS):
            qj = qc[..., c0:c0 + KS]
            P = P + mm(qj, kc[..., c0:c0 + KS].transpose(-1, -2))
            inter = inter + mm(qj, C[..., c0:c0 + KS].transpose(-1, -2))
        nq = (qc * n[:, :, None]).sum(-1)
        # the state: (V w)^T K from zero over the chunk, joined in f32
        C = cscale[..., None, None] * C + mm((vc * w[..., None]).transpose(-1, -2), kc)
        n = cscale[..., None] * n + (kc * w[..., None]).sum(2)
        m = b_c + M_c
        D = torch.where(causal, torch.exp(a[..., None, :] - M[..., :, None]), 0.0)
        Pp = P * inv * D
        den = torch.clamp((Pp.sum(-1) + cw * nq).abs(), min=1.0)
        hs.append((mm(Pp, vc) + cw[..., None] * inter) * (1.0 / den)[..., None])
    h = torch.cat(hs, dim=2)[:, :, :S].transpose(1, 2)
    return h, (C, n, m)


def f64_recurrence(q, k, v, gates, state=None):
    """h and (C, n, m) of the sequential recurrence in f64 (model layout)."""
    B, S, H, hd = q.shape
    q, k, v, gates = (t.double() for t in (q, k, v, gates))
    if state is None:
        C = torch.zeros((B, H, hd, hd), dtype=torch.float64)
        n = torch.zeros((B, H, hd), dtype=torch.float64)
        m = torch.zeros((B, H), dtype=torch.float64)
    else:
        C, n, m = (t.double() for t in state)
    hs = []
    for t in range(S):
        it, ft = gates[:, t, :H], gates[:, t, H:]
        m_new = torch.maximum(ft + m, it)
        i_, f_ = torch.exp(it - m_new), torch.exp(ft + m - m_new)
        kf = k[:, t] / math.sqrt(hd)
        C = f_[..., None, None] * C + i_[..., None, None] * (v[:, t][..., :, None] * kf[..., None, :])
        n = f_[..., None] * n + i_[..., None] * kf
        den = torch.clamp((n * q[:, t]).sum(-1).abs(), min=1.0)
        hs.append(torch.einsum("bhij,bhj->bhi", C, q[:, t]) / den[..., None])
        m = m_new
    return torch.stack(hs, dim=1), (C, n, m)


def _worst(got, want, tols) -> dict:
    """Per output, the largest |got - want| / (atol + rtol |want|): at most
    1 where its tolerance holds."""
    out = {}
    for key, g, w in zip("hCnm", (got[0], *got[1]), (want[0], *want[1])):
        w = torch.as_tensor(np.asarray(w, np.float64)) if not isinstance(w, torch.Tensor) \
            else w.double()
        lim = tols[key]["atol"] + tols[key]["rtol"] * w.abs()
        out[key] = float(((g.double() - w).abs() / lim).max())
    return out


def _jax_case(B, H, S, hd, chunk):
    a = _inputs(B, H, S, hd, seed=S * hd + chunk)
    jh, jst = jax_mlstm_chunkwise(*_jax(a, "float32"), chunk=chunk, interpret=True)
    want = (np.moveaxis(np.asarray(jh), 1, 2), tuple(np.asarray(x) for x in jst))
    return _model_layout(*_torch(a, "float32")), None, want


def _state_case():
    """Ragged S100 at hd 96 (the kernel's 32-row tiles of C) with a carried
    state, against the JAX sequential oracle."""
    a = _inputs(2, 2, 100, 96, seed=4242, with_state=True)
    jh, jst = jax_mlstm_ref(*_jax(a, "float32"), tuple(jnp.asarray(x) for x in a["state"]))
    want = (np.moveaxis(np.asarray(jh), 1, 2), tuple(np.asarray(x) for x in jst))
    return _model_layout(*_torch(a, "float32")), tuple(torch.from_numpy(x) for x in a["state"]), \
        want


def _f64_case():
    B, H, S, hd = F64_CASE
    args = _model_layout(*_torch(_inputs(B, H, S, hd, seed=11), "float32"))
    return args, None, f64_recurrence(*args)


def test_split_helpers_round_as_the_kernel():
    """rna and split as imported: hi is a TF32 value and hi + lo holds x to
    2^-22 of |x|."""
    x = torch.from_numpy(np.random.RandomState(2).randn(4096).astype(np.float32))
    hi, lo = split(x)
    assert torch.equal(rna(hi), hi) and torch.equal(rna(lo), lo)
    assert float((hi.double() + lo.double() - x.double()).abs().max()) <= \
        2.0 ** -22 * float(x.abs().max())


@pytest.mark.parametrize("B,H,S,hd,chunk", JAX_CASES)
def test_split_tf32_mlstm_matches_pallas_interpret(B, H, S, hd, chunk):
    args, state, want = _jax_case(B, H, S, hd, chunk)
    worst = _worst(chunkwise(*args, state), want, TOLS)
    assert max(worst.values()) <= 1.0, worst


def test_split_tf32_mlstm_ragged_with_state_matches_jax_oracle():
    args, state, want = _state_case()
    worst = _worst(chunkwise(*args, state), want, TOLS)
    assert max(worst.values()) <= 1.0, worst


@pytest.mark.parametrize("B,H,S,hd,chunk", JAX_CASES[:1])
def test_split_tf32_mlstm_matches_the_plain_version(B, H, S, hd, chunk):
    """The package's plain version at the kernel's chunk, which the kernel is
    held against on the card, agrees with the emulation."""
    args, state, _ = _jax_case(B, H, S, hd, chunk)
    h, (C, n, m) = mlstm_chunkwise_ref(*args, state, chunk=CH)
    worst = _worst(chunkwise(*args, state), (h, (C, n, m)), TOLS)
    assert max(worst.values()) <= 1.0, worst


def test_split_tf32_mlstm_matches_f64_at_hd512():
    args, state, want = _f64_case()
    assert max(_worst(chunkwise(*args, state), want, MAIN_TOLS).values()) <= 1.0
    assert max(_worst(chunkwise(*args, state, mm=mm_f32), want, MAIN_TOLS).values()) <= 1.0


@pytest.mark.parametrize("case", ["jax", "f64"])
def test_one_tf32_product_misses_the_tolerances(case):
    """Without the split (each operand rounded to TF32 once) the kernel's form
    leaves the tolerances: the split is needed."""
    if case == "jax":
        (args, state, want), tols = _jax_case(*JAX_CASES[2]), TOLS
    else:
        (args, state, want), tols = _f64_case(), MAIN_TOLS
    assert max(_worst(chunkwise(*args, state, mm=mm_tf32), want, tols).values()) > 1.0


if __name__ == "__main__":
    cases = [(f"JAX chunkwise B{B} H{H} S{S} hd{hd}", _jax_case(B, H, S, hd, c), TOLS)
             for B, H, S, hd, c in JAX_CASES]
    cases += [("JAX oracle ragged S100 hd96 with state", _state_case(), TOLS),
              ("f64 recurrence B{} H{} S{} hd{}".format(*F64_CASE), _f64_case(), MAIN_TOLS)]
    for name, (args, state, want), tols in cases:
        for label, mm in (("split TF32", mm_split), ("plain f32", mm_f32), ("one TF32", mm_tf32)):
            worst = _worst(chunkwise(*args, state, mm=mm), want, tols)
            print(f"{name}: {label}: worst error / limit " +
                  ", ".join(f"{k} {v:.4f}" for k, v in worst.items()))
