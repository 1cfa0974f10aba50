"""Plain PyTorch versions of the chunkwise mLSTM kernel (counterparts of
``repro/kernels/mlstm/ref.py`` and of ``repro.models.xlstm._mlstm_scan``).

Per head, with log-space gate pre-activations ĩ_t, f̃_t and stabilizer m:

    m_t = max(f̃_t + m_{t-1}, ĩ_t)
    i'  = exp(ĩ_t − m_t);  f' = exp(f̃_t + m_{t-1} − m_t)
    C_t = f'·C_{t-1} + i'·v_t (k_t/√hd)ᵀ          (layout C[d_v, d_k])
    n_t = f'·n_{t-1} + i'·(k_t/√hd)
    h_t = (C_t q_t) / max(|n_t·q_t|, 1)

``mlstm_ref`` walks that recurrence step by step (the oracle of the
kernel); ``mlstm_chunkwise_ref`` computes the same thing chunk by chunk
with matrix products, as the reference model does. Both start from an
optional state ``(C, n, m)`` (None: zeros) and return the final one in f32.
"""
from __future__ import annotations

import math
from typing import Optional, Tuple

import torch

NEG = -1e30   # ĩ of a padded step: with f̃ = 0 it leaves the state unchanged

State = Tuple[torch.Tensor, torch.Tensor, torch.Tensor]


def _zero_state(B: int, H: int, hd: int, device) -> State:
    return (torch.zeros((B, H, hd, hd), dtype=torch.float32, device=device),
            torch.zeros((B, H, hd), dtype=torch.float32, device=device),
            torch.zeros((B, H), dtype=torch.float32, device=device))


def mlstm_ref(
    q: torch.Tensor,       # (B, H, S, hd)
    k: torch.Tensor,
    v: torch.Tensor,
    gates: torch.Tensor,   # (B, H, S, 2): [..., 0] = ĩ, [..., 1] = f̃
    state: Optional[State] = None,
) -> Tuple[torch.Tensor, State]:
    """Sequential recurrence. Returns (h (B,H,S,hd) in q's dtype, (C, n, m) f32)."""
    B, H, S, hd = q.shape
    C, n, m = (_zero_state(B, H, hd, q.device) if state is None
               else tuple(t.float() for t in state))
    hs = []
    for t in range(S):
        it, ft = gates[:, :, t, 0].float(), gates[:, :, t, 1].float()
        m_new = torch.maximum(ft + m, it)
        i_ = torch.exp(it - m_new)
        f_ = torch.exp(ft + m - m_new)
        kf = k[:, :, t].float() / math.sqrt(hd)
        C = f_[..., None, None] * C + i_[..., None, None] * (
            v[:, :, t].float()[..., :, None] * kf[..., None, :])
        n = f_[..., None] * n + i_[..., None] * kf
        qf = q[:, :, t].float()
        num = torch.einsum("bhij,bhj->bhi", C, qf)
        den = torch.clamp(torch.einsum("bhj,bhj->bh", n, qf).abs(), min=1.0)
        hs.append(num / den[..., None])
        m = m_new
    return torch.stack(hs, dim=2).to(q.dtype), (C, n, m)


def mlstm_chunkwise_ref(
    q: torch.Tensor,       # (B, S, H, hd)
    k: torch.Tensor,
    v: torch.Tensor,
    gates: torch.Tensor,   # (B, S, 2H): ĩ in [..., :H], f̃ in [..., H:]
    state: Optional[State] = None,
    chunk: int = 64,
) -> Tuple[torch.Tensor, State]:
    """The chunkwise form in the model's layout. Within a chunk (b =
    cumsum(f̃), inclusive; K̂ = K/√hd):

        M_t   = max(m_in, cummax_{s≤t}(ĩ_s − b_s)),   m_t = b_t + M_t
        D_ts  = exp(ĩ_s − b_s − M_t)  for s ≤ t, else 0
        h_t   = ((q K̂ᵀ ⊙ D) V + exp(m_in − M_t)·q C_inᵀ)_t / max(|n_t·q_t|, 1)

    A ragged S is padded to a whole chunk with ĩ = -1e30, f̃ = 0 and zero
    q/k/v, which leaves the state unchanged (the JAX wrapper's rule).
    Returns (h (B,S,H,hd) in q's dtype, (C, n, m) f32)."""
    B, S, H, hd = q.shape
    C, n, m = (_zero_state(B, H, hd, q.device) if state is None
               else tuple(t.float() for t in state))
    c = max(1, min(chunk, S))
    pad = (-S) % c
    qf, kf, vf = q.float(), k.float() / math.sqrt(hd), v.float()
    ig, fg = gates[..., :H].float(), gates[..., H:].float()
    if pad:
        z = lambda x: torch.nn.functional.pad(x, (0, 0, 0, 0, 0, pad))
        qf, kf, vf = z(qf), z(kf), z(vf)
        ig = torch.nn.functional.pad(ig, (0, 0, 0, pad), value=NEG)
        fg = torch.nn.functional.pad(fg, (0, 0, 0, pad))
    tri = torch.tril(torch.ones((c, c), dtype=torch.bool, device=q.device))
    hs = []
    for c0 in range(0, S + pad, c):
        qt, kt, vt = qf[:, c0:c0 + c], kf[:, c0:c0 + c], vf[:, c0:c0 + c]   # (B,c,H,hd)
        b = torch.cumsum(fg[:, c0:c0 + c], dim=1)                           # (B,c,H)
        a = ig[:, c0:c0 + c] - b
        M = torch.maximum(m[:, None, :], torch.cummax(a, dim=1).values)
        D = torch.where(tri[None, :, :, None],
                        torch.exp(a[:, None, :, :] - M[:, :, None, :]), 0.0)   # (B,t,s,H)
        qk = torch.einsum("bthd,bshd->btsh", qt, kt)
        num = torch.einsum("btsh,bshd->bthd", qk * D, vt)
        carry_w = torch.exp(m[:, None, :] - M)                               # (B,c,H)
        num = num + carry_w[..., None] * torch.einsum("bthd,bhed->bthe", qt, C)
        n_t = torch.einsum("btsh,bshd->bthd", D, kt) + carry_w[..., None] * n[:, None]
        den = torch.clamp((n_t * qt).sum(-1).abs(), min=1.0)
        hs.append(num / den[..., None])
        M_c = M[:, -1]                                                       # (B,H)
        w = torch.exp(a - M_c[:, None, :])                                   # (B,c,H)
        C_new = torch.einsum("bshd,bshe->bhde", vt * w[..., None], kt)
        cscale = torch.exp(m - M_c)
        C = cscale[..., None, None] * C + C_new
        n = cscale[..., None] * n + (kt * w[..., None]).sum(1)
        m = b[:, -1] + M_c
    return torch.cat(hs, dim=1)[:, :S].to(q.dtype), (C, n, m)


def mlstm_step_ref(
    q: torch.Tensor,       # (B, S, H, hd), S a few timesteps
    k: torch.Tensor,
    v: torch.Tensor,
    gates: torch.Tensor,   # (B, S, 2H): ĩ in [..., :H], f̃ in [..., H:]
    state: Optional[State] = None,
) -> Tuple[torch.Tensor, State]:
    """The decode-step kernel's one-pass form, in the model's layout: per
    timestep n is updated first and n'·q taken, then each row i of C is
    updated and used in the same pass,

        C'[i, :] = f'·C[i, :] + i'·v_i·k̂,   h_i = C'[i, :]·q / max(|n'·q|, 1).

    Returns (h (B,S,H,hd) in q's dtype, (C, n, m) f32)."""
    B, S, H, hd = q.shape
    C, n, m = (_zero_state(B, H, hd, q.device) if state is None
               else tuple(t.float() for t in state))
    hs = []
    for t in range(S):
        it, ft = gates[:, t, :H].float(), gates[:, t, H:].float()          # (B, H)
        m_new = torch.maximum(ft + m, it)
        i_, f_ = torch.exp(it - m_new), torch.exp(ft + m - m_new)
        kf = k[:, t].float() / math.sqrt(hd)                                # (B, H, hd)
        qf = q[:, t].float()
        n = f_[..., None] * n + i_[..., None] * kf
        inv_den = 1.0 / torch.clamp((n * qf).sum(-1).abs(), min=1.0)       # (B, H)
        C = f_[..., None, None] * C + (i_[..., None] * v[:, t].float())[..., None] * kf[..., None, :]
        hs.append(torch.einsum("bhij,bhj->bhi", C, qf) * inv_den[..., None])
        m = m_new
    return torch.stack(hs, dim=1).to(q.dtype), (C, n, m)


def _hilo(x: torch.Tensor, terms: int = 2) -> Tuple[torch.Tensor, ...]:
    """x (f32) as ``terms`` bf16 terms, each back in f32: hi = bf16(x),
    then each next term bf16 of what is left."""
    out = []
    for _ in range(terms):
        t = x.to(torch.bfloat16).float()
        out.append(t)
        x = x - t
    return tuple(out)


def mlstm_chunkwise_hilo_ref(
    q: torch.Tensor,       # (B, S, H, hd) bf16
    k: torch.Tensor,
    v: torch.Tensor,
    gates: torch.Tensor,   # (B, S, 2H)
    state: Optional[State] = None,
    chunk: int = 64,
) -> Tuple[torch.Tensor, State]:
    """The tensor-core prefill kernel's rounding scheme, emulated in f32:
    its chunk of 64; every product takes bf16 operands with f32 sums; q,
    K and V enter exact (bf16 inputs), 1/√hd applied in f32 after q Kᵀ; the
    f32 operands C_in and V·w/√hd enter as hi + lo bf16 halves, two products
    each, and P' = (q Kᵀ/√hd) ⊙ D as three bf16 terms; the state stays f32. A ragged S is padded
    as ``mlstm_chunkwise_ref`` pads it. Returns (h (B,S,H,hd) in q's dtype,
    (C, n, m) f32)."""
    B, S, H, hd = q.shape
    C, n, m = (_zero_state(B, H, hd, q.device) if state is None
               else tuple(t.float() for t in state))
    c = max(1, min(chunk, S))
    pad = (-S) % c
    qf, kf, vf = q.float(), k.float(), v.float()
    ig, fg = gates[..., :H].float(), gates[..., H:].float()
    if pad:
        z = lambda x: torch.nn.functional.pad(x, (0, 0, 0, 0, 0, pad))
        qf, kf, vf = z(qf), z(kf), z(vf)
        ig = torch.nn.functional.pad(ig, (0, 0, 0, pad), value=NEG)
        fg = torch.nn.functional.pad(fg, (0, 0, 0, pad))
    inv = 1.0 / math.sqrt(hd)
    tri = torch.tril(torch.ones((c, c), dtype=torch.bool, device=q.device))
    two = lambda x, y, eq, terms=2: sum(torch.einsum(eq, t, y) for t in _hilo(x, terms))
    hs = []
    for c0 in range(0, S + pad, c):
        qt, kt, vt = qf[:, c0:c0 + c], kf[:, c0:c0 + c], vf[:, c0:c0 + c]   # (B,c,H,hd)
        b = torch.cumsum(fg[:, c0:c0 + c], dim=1)                           # (B,c,H)
        a = ig[:, c0:c0 + c] - b
        M = torch.maximum(m[:, None, :], torch.cummax(a, dim=1).values)
        D = torch.where(tri[None, :, :, None],
                        torch.exp(a[:, None, :, :] - M[:, :, None, :]), 0.0)   # (B,t,s,H)
        P = torch.einsum("bthd,bshd->btsh", qt, kt) * inv * D
        carry_w = torch.exp(m[:, None, :] - M)                               # (B,c,H)
        inter = two(C, qt, "bhed,bthd->bthe")
        num = two(P, vt, "btsh,bshd->bthd", 3) + carry_w[..., None] * inter
        nq = (qt * n[:, None]).sum(-1)                                       # (B,c,H)
        den = torch.clamp((P.sum(2) + carry_w * nq).abs(), min=1.0)
        hs.append(num / den[..., None])
        M_c = M[:, -1]
        w = torch.exp(a - M_c[:, None, :]) * inv                             # (B,c,H)
        cscale = torch.exp(m - M_c)
        C = cscale[..., None, None] * C + two(vt * w[..., None], kt, "bshd,bshe->bhde")
        n = cscale[..., None] * n + (kt * w[..., None]).sum(1)
        m = b[:, -1] + M_c
    return torch.cat(hs, dim=1)[:, :S].to(q.dtype), (C, n, m)


def mlstm_chunkwise_split_ref(
    q: torch.Tensor,       # (B, S, H, hd) bf16
    k: torch.Tensor,
    v: torch.Tensor,
    gates: torch.Tensor,   # (B, S, 2H)
    state: Optional[State] = None,
    chunk: int = 64,
    tile: int = 64,
):
    """The tensor-core kernel's split design (``csrc/mlstm_tc.cu``: a carry
    pass, then an output pass), in plain PyTorch, with the rounding of
    ``mlstm_chunkwise_hilo_ref``. The carry takes each ``tile`` x ``tile``
    tile of C through the chunks on its own, C = cscale C + (V w/√hd)ᵀ K with
    V w as hi + lo bf16 halves, n beside it, and keeps C, n, m at each
    chunk's start. The output pass computes each chunk's h from those alone:
    P' = (q Kᵀ/√hd) ⊙ D as three bf16 terms, C_in as hi + lo halves,

        h_t = (P' V + exp(m_in − M_t) q C_inᵀ)_t / max(|n_t·q_t|, 1),
        n_t·q_t = Σ_s P'_ts + exp(m_in − M_t) n_in·q_t.

    A ragged S is padded as ``mlstm_chunkwise_ref`` pads it. Returns (h
    (B,S,H,hd) in q's dtype, (C, n, m) f32, kept): what the kernel keeps for
    the gradient (``kernel.Kept``), C_in (B,H,NC,hd,hd), n_in (B,H,NC,hd),
    m_in (B,H,NC) and n_t·q_t (B,S,H)."""
    B, S, H, hd = q.shape
    if hd % tile:
        raise ValueError(f"mlstm_chunkwise_split_ref: hd {hd} is not a multiple of tile {tile}")
    C, n, m = (_zero_state(B, H, hd, q.device) if state is None
               else tuple(t.float() for t in state))
    c = max(1, min(chunk, S))
    pad = (-S) % c
    qf, kf, vf = q.float(), k.float(), v.float()
    ig, fg = gates[..., :H].float(), gates[..., H:].float()
    if pad:
        z = lambda x: torch.nn.functional.pad(x, (0, 0, 0, 0, 0, pad))
        qf, kf, vf = z(qf), z(kf), z(vf)
        ig = torch.nn.functional.pad(ig, (0, 0, 0, pad), value=NEG)
        fg = torch.nn.functional.pad(fg, (0, 0, 0, pad))
    inv = 1.0 / math.sqrt(hd)
    tri = torch.tril(torch.ones((c, c), dtype=torch.bool, device=q.device))
    two = lambda x, y, eq, terms=2: sum(torch.einsum(eq, t, y) for t in _hilo(x, terms))

    def scalars(c0, m_in):
        """The chunk's a_s, M_t and M at its last step, from m_in."""
        b = torch.cumsum(fg[:, c0:c0 + c], dim=1)                           # (B,c,H)
        a = ig[:, c0:c0 + c] - b
        M = torch.maximum(m_in[:, None, :], torch.cummax(a, dim=1).values)
        return b, a, M

    # the carry: each chunk's w and cscale (every tile of a head the same),
    # then each tile of C through the chunks, and n
    steps, m_ins = [], []
    for c0 in range(0, S + pad, c):
        b, a, M = scalars(c0, m)
        M_c = M[:, -1]
        steps.append((c0, torch.exp(a - M_c[:, None, :]) * inv, torch.exp(m - M_c)))
        m_ins.append(m)
        m = b[:, -1] + M_c
    nc = len(steps)
    kC = torch.empty((B, H, nc, hd, hd), dtype=torch.float32, device=q.device)
    kn = torch.empty((B, H, nc, hd), dtype=torch.float32, device=q.device)
    C_end = torch.empty_like(C)
    for r0 in range(0, hd, tile):
        rows = slice(r0, r0 + tile)
        for col0 in range(0, hd, tile):
            cols = slice(col0, col0 + tile)
            Ct = C[:, :, rows, cols]
            for ci, (c0, w, cscale) in enumerate(steps):
                kC[:, :, ci, rows, cols] = Ct
                Ct = cscale[..., None, None] * Ct + two(
                    vf[:, c0:c0 + c, :, rows] * w[..., None], kf[:, c0:c0 + c, :, cols],
                    "bshd,bshe->bhde")
            C_end[:, :, rows, cols] = Ct
    for ci, (c0, w, cscale) in enumerate(steps):
        kn[:, :, ci] = n
        n = cscale[..., None] * n + (kf[:, c0:c0 + c] * w[..., None]).sum(1)
    km = torch.stack(m_ins, dim=2)

    # the output pass: each chunk from its C_in, n_in and m_in alone
    hs, nqs = [], []
    for ci, (c0, _, _) in enumerate(steps):
        C_in, n_in, m_in = kC[:, :, ci], kn[:, :, ci], km[:, :, ci]
        qt, kt, vt = qf[:, c0:c0 + c], kf[:, c0:c0 + c], vf[:, c0:c0 + c]
        _, a, M = scalars(c0, m_in)
        D = torch.where(tri[None, :, :, None],
                        torch.exp(a[:, None, :, :] - M[:, :, None, :]), 0.0)   # (B,t,s,H)
        P = torch.einsum("bthd,bshd->btsh", qt, kt) * inv * D
        cw = torch.exp(m_in[:, None, :] - M)                                 # (B,c,H)
        num = two(P, vt, "btsh,bshd->bthd", 3) + cw[..., None] * two(C_in, qt, "bhed,bthd->bthe")
        nqt = P.sum(2) + cw * (qt * n_in[:, None]).sum(-1)                   # (B,c,H)
        hs.append(num / torch.clamp(nqt.abs(), min=1.0)[..., None])
        nqs.append(nqt)
    kept = (kC, kn, km, torch.cat(nqs, dim=1)[:, :S])
    return torch.cat(hs, dim=1)[:, :S].to(q.dtype), (C_end, n, m), kept


def _stabilizer_chain(won: torch.Tensor, e: torch.Tensor):
    """Part (b) of ``mlstm_chunkwise_bwd_ref``: ``e`` (B, S, H), each step's
    gradient of the loss by its stabilizer m_t with the chunkwise form held
    fixed, carried back along m_t = max(f̃_t + m_{t−1}, ĩ_t) (``won``: ĩ_t
    won). Returns its shares of dĩ and df̃ (B, S, H) and of the start
    state's dm (B, H)."""
    d_i, d_f = torch.zeros_like(e), torch.zeros_like(e)
    g = torch.zeros_like(e[:, 0])
    for t in reversed(range(e.shape[1])):
        g = g + e[:, t]
        d_i[:, t] = torch.where(won[:, t], g, 0.0)
        d_f[:, t] = torch.where(won[:, t], 0.0, g)
        g = torch.where(won[:, t], 0.0, g)
    return d_i, d_f, g


def _sweep(q, k, v, gates, state, chunk):
    """The forward sweep of ``mlstm_chunkwise_bwd_ref``: the inputs in its
    working type (f64 given f64, else f32), padded to whole chunks (ĩ = NEG
    past S), k scaled by 1/√hd, and each chunk's (C_in, n_in, m_in, a, M,
    D, P ⊙ D, carry, n·q); returns (working type, chunk, pad, 1/√hd, q, k̂,
    v, ĩ, f̃, the chunks' list, the final (C, n, m))."""
    B, S, H, hd = q.shape
    dev = q.device
    wd = torch.float64 if q.dtype == torch.float64 else torch.float32
    C, n, m = (t.to(wd) for t in (_zero_state(B, H, hd, dev) if state is None else state))
    c = max(1, min(chunk, S))
    pad = (-S) % c
    inv = 1.0 / math.sqrt(hd)
    qf, kf, vf = q.to(wd), k.to(wd) * inv, v.to(wd)
    ig, fg = gates[..., :H].to(wd), gates[..., H:].to(wd)
    if pad:
        z = lambda x: torch.nn.functional.pad(x, (0, 0, 0, 0, 0, pad))
        qf, kf, vf = z(qf), z(kf), z(vf)
        ig = torch.nn.functional.pad(ig, (0, 0, 0, pad), value=NEG)
        fg = torch.nn.functional.pad(fg, (0, 0, 0, pad))
    tri = torch.tril(torch.ones((c, c), dtype=torch.bool, device=dev))
    sl = lambda x, c0: x[:, c0:c0 + c]
    kept = []
    for c0 in range(0, S + pad, c):
        qt, kt, vt = sl(qf, c0), sl(kf, c0), sl(vf, c0)
        b = torch.cumsum(sl(fg, c0), dim=1)
        a = sl(ig, c0) - b
        M = torch.maximum(m[:, None, :], torch.cummax(a, dim=1).values)      # (B,c,H)
        D = torch.where(tri[None, :, :, None],
                        torch.exp(a[:, None, :, :] - M[:, :, None, :]), 0.0)  # (B,t,s,H)
        PD = torch.einsum("bthd,bshd->btsh", qt, kt) * D
        cw = torch.exp(m[:, None, :] - M)
        nq = PD.sum(2) + cw * torch.einsum("bthd,bhd->bth", qt, n)
        kept.append((C, n, m, a, M, D, PD, cw, nq))
        M_c = M[:, -1]
        w = torch.exp(a - M_c[:, None, :])
        cscale = torch.exp(m - M_c)
        C = cscale[..., None, None] * C + torch.einsum("bshd,bshe->bhde", vt * w[..., None], kt)
        n = cscale[..., None] * n + (kt * w[..., None]).sum(1)
        m = b[:, -1] + M_c
    return wd, c, pad, inv, qf, kf, vf, ig, fg, kept, (C, n, m)


def _step_terms(kept, h, dh, pad, wd):
    """Each step's dh·h, whether its denominator is free (|n·q| > 1), φ and
    δ = dh / den (padded as the sweep's inputs)."""
    hf, dhf = h.to(wd), dh.to(wd)
    if pad:
        z = lambda x: torch.nn.functional.pad(x, (0, 0, 0, 0, 0, pad))
        hf, dhf = z(hf), z(dhf)
    dhh = (dhf * hf).sum(-1)                                                  # (B,Sp,H)
    nq_all = torch.cat([x[-1] for x in kept], dim=1)
    den = torch.clamp(nq_all.abs(), min=1.0)
    free = nq_all.abs() > 1.0
    phi = torch.where(free, -torch.sign(nq_all) * dhh / den, 0.0)
    return dhh, free, phi, dhf / den[..., None]


def mlstm_chunkwise_bwd_ref(
    q: torch.Tensor,       # (B, S, H, hd)
    k: torch.Tensor,
    v: torch.Tensor,
    gates: torch.Tensor,   # (B, S, 2H): ĩ in [..., :H], f̃ in [..., H:]
    state: Optional[State],
    h: torch.Tensor,       # (B, S, H, hd): the forward's output
    dh: torch.Tensor,      # (B, S, H, hd)
    dstate: Optional[Tuple[Optional[torch.Tensor], ...]] = None,   # (dC, dn, dm) of the final state
    chunk: int = 64,
) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor, torch.Tensor, Optional[State]]:
    """The gradient of ``mlstm_chunkwise_ref``, derived by hand: the plain
    version of the CUDA backward (``csrc/mlstm_bwd.cu``), in its order.

    With m_t the stepwise stabilizer, h depends on m_t only where the
    clamp max(|n_t·q_t|, 1) holds h_t = num_t (num_t scales as exp(−m_t));
    elsewhere m cancels between num and den. So the gradient is the sum of
    (a) the chunkwise form's gradient with every m_t held constant, and
    (b) a scalar reverse pass: at each clamped step g_t = −(dh_t·h_t) (and
    at the last step the final state's −⟨dC, C⟩ − ⟨dn, n⟩ + dm), carried
    back along the stabilizer's argmax chain m_t = max(f̃_t + m_{t−1}, ĩ_t):
    into dĩ_t where ĩ_t won (the carry ends), else into df̃_t and on to t−1,
    and from step 0 into dm of the start state.

    (a) treats n as one more value row of C (v' = [v, 1]) whose gradient
    is φ_t = −sign(n_t·q_t)·(dh_t·h_t)/den_t where |n_t·q_t| > 1, else 0,
    and δ_t = dh_t/den_t for the others. Per chunk, with P_ts = q_t·k̂_s,
    D_ts = exp(ĩ_s − b_s + b_t − m_t) (s ≤ t), carry_t = exp(m_in + b_t −
    m_t), w_s = exp(ĩ_s − b_s + b_E − m_E) and cscale = exp(m_in + b_E − m_E)
    (E the chunk's last step), dC' the gradient of the chunk's end state:

        dP_ts = δ_t·v_s + φ_t,   G = dP ⊙ D,   gD = dP ⊙ P ⊙ D
        dq_t  = Σ_s G_ts k̂_s + carry_t (C_inᵀ δ_t + φ_t n_in)
        dk̂_s  = Σ_t G_ts q_t + w_s (dCᵀ v_s + dn)
        dv_s  = Σ_t (P ⊙ D)_ts δ_t + w_s dC k̂_s
        dĩ_s  = Σ_t gD_ts + w_s (v_s·dC k̂_s + dn·k̂_s)
        db_t  = −dĩ_t + dh_t·h_t + φ_t n_t·q_t  (+ Σ_s w_s(...) + cscale ⟨dC', C'_in⟩ at E)

    and df̃ is db's reverse cumsum over the chunk. The carry's log-gradient
    dh_t·h_t + φ_t n_t·q_t − Σ_s gD_ts uses δ'_t·num'_t = dh_t·h_t + φ_t n_t·q_t,
    so C_in q_t is never formed. The chunk hands back dC' ← cscale dC' +
    Σ_t carry_t δ'_t q_tᵀ. Only the start state's m gets (a)'s m terms
    (chunk 0's carry and cscale); every later m_in is a held m_t.

    Returns (dq, dk, dv in q's dtype, dgates (B, S, 2H) f32, the start
    state's (dC, dn, dm) f32, or None without a start state). Given f64
    inputs it works, and returns everything, in f64: a witness of the f32
    sums' rounding."""
    B, S, H, hd = q.shape
    dev = q.device
    wd, c, pad, inv, qf, kf, vf, ig, fg, kept, (C, n, m) = _sweep(q, k, v, gates, state, chunk)
    sl = lambda x, c0: x[:, c0:c0 + c]
    dhh, free, phi, delta = _step_terms(kept, h, dh, pad, wd)

    dC = torch.zeros_like(C)
    dn = torch.zeros_like(n)
    e_last = torch.zeros((B, H), dtype=wd, device=dev)
    if dstate is not None:
        dCf, dnf, dmf = dstate
        if dCf is not None:
            dC = dCf.to(wd).clone()
            e_last = e_last - (dC * C).sum((-1, -2))
        if dnf is not None:
            dn = dnf.to(wd).clone()
            e_last = e_last - (dn * n).sum(-1)
        if dmf is not None:
            e_last = e_last + dmf.to(wd)

    dq, dk, dv = torch.zeros_like(qf), torch.zeros_like(kf), torch.zeros_like(vf)
    di, df = torch.zeros_like(ig), torch.zeros_like(fg)
    dm0 = torch.zeros((B, H), dtype=wd, device=dev)
    for ci in reversed(range(len(kept))):
        c0 = ci * c
        C_in, n_in, m_in, a, M, D, PD, cw, nq = kept[ci]
        qt, kt, vt = sl(qf, c0), sl(kf, c0), sl(vf, c0)
        dl, ph, hh = sl(delta, c0), sl(phi, c0), sl(dhh, c0)
        dP = torch.einsum("bthd,bshd->btsh", dl, vt) + ph[:, :, None, :]
        G = dP * D
        gD = dP * PD
        w = torch.exp(a - M[:, -1:, :])
        cscale = torch.exp(m_in - M[:, -1])
        U = torch.einsum("bshe,bhde->bshd", kt, dC)                          # dC k̂_s
        dq[:, c0:c0 + c] = torch.einsum("btsh,bshd->bthd", G, kt) + cw[..., None] * (
            torch.einsum("bthe,bhed->bthd", dl, C_in) + ph[..., None] * n_in[:, None])
        dk[:, c0:c0 + c] = torch.einsum("btsh,bthd->bshd", G, qt) + w[..., None] * (
            torch.einsum("bshe,bhed->bshd", vt, dC) + dn[:, None])
        dv[:, c0:c0 + c] = torch.einsum("btsh,bthd->bshd", PD, dl) + w[..., None] * U
        gw = w * ((vt * U).sum(-1) + torch.einsum("bshd,bhd->bsh", kt, dn))
        gcs = cscale * ((dC * C_in).sum((-1, -2)) + (dn * n_in).sum(-1))
        d_i = gD.sum(1) + gw
        c0_t = hh + ph * nq
        db = c0_t - d_i
        db[:, -1] += gw.sum(1) + gcs
        di[:, c0:c0 + c] = d_i
        df[:, c0:c0 + c] = torch.flip(torch.cumsum(torch.flip(db, [1]), 1), [1])
        if ci == 0:
            dm0 = c0_t.sum(1) - gD.sum((1, 2)) + gcs
        dC = cscale[..., None, None] * dC + torch.einsum("bthd,bthe->bhde", dl * cw[..., None], qt)
        dn = cscale[..., None] * dn + torch.einsum("bth,bthe->bhe", ph * cw, qt)

    # (b): ĩ_t won the stabilizer's max where a_t > M_{t−1} (M_{−1} = m_in)
    won = torch.cat([x[3] > torch.cat([x[2][:, None], x[4][:, :-1]], 1) for x in kept], 1)
    e = torch.where(free, 0.0, -dhh)[:, :S].clone()
    e[:, S - 1] += e_last
    b_i, b_f, b_m = _stabilizer_chain(won[:, :S], e)
    di[:, :S] += b_i
    df[:, :S] += b_f
    dm0 = dm0 + b_m

    dgates = torch.cat([di, df], dim=-1)[:, :S]
    dstate0 = None if state is None else (dC, dn, dm0)
    return (dq[:, :S].to(q.dtype), (dk[:, :S] * inv).to(q.dtype), dv[:, :S].to(q.dtype),
            dgates, dstate0)


def mlstm_bwd_carry_tiles_ref(
    q: torch.Tensor,       # (B, S, H, hd)
    k: torch.Tensor,
    v: torch.Tensor,
    gates: torch.Tensor,   # (B, S, 2H)
    state: Optional[State],
    h: torch.Tensor,       # (B, S, H, hd): the forward's output
    dh: torch.Tensor,      # (B, S, H, hd)
    dstate: Optional[Tuple[Optional[torch.Tensor], ...]] = None,   # (dC, dn, dm) of the final state
    chunk: int = 64,
    tile: int = 64,
) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor, torch.Tensor]:
    """The carry pass of ``csrc/mlstm_bwd.cu`` as the kernel splits it, in
    plain PyTorch: the per-step coefficients its prep writes (carry_t /
    den_t and carry_t φ_t, and each chunk's cscale), then each (value-row
    tile, column tile) of dC, ``tile`` x ``tile``, stepped back over the
    chunks on its own, dC ← cscale dC + Σ_t (carry_t / den_t) dh_t q_tᵀ;
    the tiles of value rows 0.. also step the n row's columns back with
    carry_t φ_t. Returns the gradient of each chunk's end state, dC (B, H,
    NC, hd, hd) and dn (B, H, NC, hd), and of the start state, dC0 and dn0,
    in the working type of ``mlstm_chunkwise_bwd_ref`` (whose dC0 and dn0
    these are, summed in the kernel's order)."""
    B, S, H, hd = q.shape
    if hd % tile:
        raise ValueError(f"mlstm_bwd_carry_tiles_ref: hd {hd} is not a multiple of tile {tile}")
    wd, c, pad, _, qf, _, _, _, _, kept, _ = _sweep(q, k, v, gates, state, chunk)
    _, _, phi, _ = _step_terms(kept, h, dh, pad, wd)
    dhf = dh.to(wd)
    if pad:
        dhf = torch.nn.functional.pad(dhf, (0, 0, 0, 0, 0, pad))
    nc = len(kept)
    # the prep: per chunk, carry_t / den_t and carry_t φ_t (B, c, H), cscale (B, H)
    coef = []
    for ci, (_, _, m_in, _, M, _, _, cw, nq) in enumerate(kept):
        den = torch.clamp(nq.abs(), min=1.0)
        coef.append((cw / den, cw * phi[:, ci * c:(ci + 1) * c], torch.exp(m_in - M[:, -1])))
    dCf, dnf = (dstate[0], dstate[1]) if dstate is not None else (None, None)
    dC_end = torch.zeros((B, H, nc, hd, hd), dtype=wd, device=q.device)
    dn_end = torch.zeros((B, H, nc, hd), dtype=wd, device=q.device)
    dC0 = torch.zeros((B, H, hd, hd), dtype=wd, device=q.device)
    dn0 = torch.zeros((B, H, hd), dtype=wd, device=q.device)
    for c0 in range(0, hd, tile):
        cols = slice(c0, c0 + tile)
        for r0 in range(0, hd, tile):
            rows = slice(r0, r0 + tile)
            dC = (dCf[:, :, rows, cols].to(wd).clone() if dCf is not None
                  else torch.zeros((B, H, tile, tile), dtype=wd, device=q.device))
            for ci in reversed(range(nc)):
                cd, _, cscale = coef[ci]
                t0 = ci * c
                dC_end[:, :, ci, rows, cols] = dC
                dC = cscale[..., None, None] * dC + torch.einsum(
                    "bthd,bthe->bhde", dhf[:, t0:t0 + c, :, rows] * cd[..., None],
                    qf[:, t0:t0 + c, :, cols])
            dC0[:, :, rows, cols] = dC
        dn = (dnf[:, :, cols].to(wd).clone() if dnf is not None
              else torch.zeros((B, H, tile), dtype=wd, device=q.device))
        for ci in reversed(range(nc)):
            _, cph, cscale = coef[ci]
            t0 = ci * c
            dn_end[:, :, ci, cols] = dn
            dn = cscale[..., None] * dn + torch.einsum("bth,bthe->bhe", cph,
                                                       qf[:, t0:t0 + c, :, cols])
        dn0[:, :, cols] = dn
    return dC_end, dn_end, dC0, dn0
