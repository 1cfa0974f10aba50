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
