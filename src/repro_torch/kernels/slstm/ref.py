"""Plain PyTorch versions of the sLSTM recurrence (the counterpart of the
reference's ``lax.scan`` in ``repro.models.xlstm.slstm_block``) and of its
gradient.

Per batch row and hidden unit, with ``pre = wx_t + h_{t-1} r`` split into
the gate columns z, i, f, o (offsets 0, d, 2d, 3d of the 4d columns):

    z = tanh(z~),  o = sigmoid(o~)
    m_t = max(f~ + m_{t-1}, i~)
    i'  = exp(i~ − m_t);  f' = exp(f~ + m_{t-1} − m_t)
    c_t = f'·c_{t-1} + i'·z;  n_t = f'·n_{t-1} + i'
    h_t = o·c_t / max(n_t, 1)

``slstm_ref`` walks it step by step (what the model ran before the kernel,
and what the CPU runs); with ``keep`` it also returns what the gradient
starts from: every step's pre-activations and c, n, m. ``slstm_bwd_ref``
is the reverse recurrence written out by hand, in the order torch autograd
takes through ``slstm_ref``: ``torch.maximum`` gives half of the gradient
to each side where ``f~ + m == i~``, and ``torch.clamp(n, min=1)`` passes
all of it where ``n == 1`` (the reference's ``jnp.maximum`` passes half
there). ``n == 1`` holds exactly at the first step from a zero state
whenever ``i~ > f~``; there ``n = i' = 1`` whatever the gates, so no
input's gradient sees the difference.
"""
from __future__ import annotations

from typing import Optional, Tuple

import torch

State = Tuple[torch.Tensor, torch.Tensor, torch.Tensor, torch.Tensor]   # c, n, h, m (B, d)
# what a forward keeps for the gradient: pre (B, S, 4d) and c, n, m (B, S, d)
Kept = Tuple[torch.Tensor, torch.Tensor, torch.Tensor, torch.Tensor]


def _start(state: Optional[State], B: int, d: int, like: torch.Tensor) -> State:
    if state is None:
        zero = torch.zeros((B, d), dtype=like.dtype, device=like.device)
        return zero, zero, zero, zero
    return tuple(t.to(like.dtype) for t in state)


def slstm_ref(
    wx: torch.Tensor,                 # (B, S, 4d): x w_gates + b_gates
    r: torch.Tensor,                  # (d, 4d) recurrent weights
    state: Optional[State] = None,    # (c, n, h, m), each (B, d); None: zeros
    keep: bool = False,
):
    """Returns (hs (B, S, d), (c, n, h, m)) in wx's dtype (f32 on the model's
    path, f64 for a witness), and with ``keep`` also ``Kept``, a third
    element."""
    B, S, d4 = wx.shape
    d = d4 // 4
    c, n, h, m = _start(state, B, d, wx)
    hs, kept = [], ([], [], [], [])
    for t in range(S):
        pre = wx[:, t] + torch.matmul(h, r)
        zt, it, ft, ot = pre.chunk(4, dim=-1)
        zt = torch.tanh(zt)
        ot = torch.sigmoid(ot)
        m_new = torch.maximum(ft + m, it)
        i_ = torch.exp(it - m_new)
        f_ = torch.exp(ft + m - m_new)
        c = f_ * c + i_ * zt
        n = f_ * n + i_
        h = ot * c / torch.clamp(n, min=1.0)
        m = m_new
        hs.append(h)
        if keep:
            for out, x in zip(kept, (pre, c, n, m)):
                out.append(x)
    out = torch.stack(hs, dim=1), (c, n, h, m)
    if keep:
        return (*out, tuple(torch.stack(x, dim=1) for x in kept))
    return out


def slstm_bwd_ref(
    r: torch.Tensor,                  # (d, 4d)
    state: Optional[State],           # the start state (c, n, h, m); None: zeros
    hs: torch.Tensor,                 # (B, S, d) the forward's output
    kept: Kept,                       # what the forward kept (``keep=True``)
    dhs: Optional[torch.Tensor],      # (B, S, d); None: zeros
    dstate: Optional[Tuple[Optional[torch.Tensor], ...]] = None,   # final (dc, dn, dh, dm)
) -> Tuple[torch.Tensor, torch.Tensor, Optional[State]]:
    """The gradient of ``slstm_ref``. Returns (dwx (B, S, 4d), dr (d, 4d),
    the start state's (dc, dn, dh, dm) when ``state`` is given, else None),
    in hs's dtype. ``dwx`` is each step's dpre; ``dr`` is one product of
    the h each step read with it."""
    pre, cs, ns, ms = kept
    B, S, d = hs.shape
    c0, n0, h0, m0 = _start(state, B, d, hs)
    dc, dn, dh_rec, dm = (torch.zeros_like(c0) if x is None else x.to(hs.dtype)
                          for x in (dstate or (None,) * 4))
    dpre = torch.empty_like(pre)
    for t in range(S - 1, -1, -1):
        zt, it, ft, ot = pre[:, t].chunk(4, dim=-1)
        z, o = torch.tanh(zt), torch.sigmoid(ot)
        c_prev, n_prev, m_prev = ((c0, n0, m0) if t == 0 else
                                  (cs[:, t - 1], ns[:, t - 1], ms[:, t - 1]))
        c, n, m = cs[:, t], ns[:, t], ms[:, t]
        a = ft + m_prev
        i_ = torch.exp(it - m)
        f_ = torch.exp(a - m)
        nc = torch.clamp(n, min=1.0)
        dh = dh_rec if dhs is None else dhs[:, t] + dh_rec
        # h = (o c) / nc
        g = dh / nc
        do = g * c
        dc = dc + g * o
        dn = dn + torch.where(n >= 1.0, -dh * (hs[:, t] / nc), torch.zeros_like(n))
        dzt = dc * i_ * (1 - z * z)
        dot = do * (1 - o) * o
        di_ = dc * z + dn
        df_ = dc * c_prev + dn * n_prev
        dm = dm - di_ * i_ - df_ * f_
        # m = max(a, i~): half of dm to each side at a tie
        tie = a == it
        da = torch.where(tie, dm / 2, torch.where(a > it, dm, torch.zeros_like(dm)))
        dit = di_ * i_ + (dm - da)
        da = df_ * f_ + da
        dpre[:, t] = torch.cat([dzt, dit, da, dot], dim=-1)
        dc, dn, dm = dc * f_, dn * f_, da
        dh_rec = torch.matmul(dpre[:, t], r.T)
    h_prev = torch.cat([h0[:, None], hs[:, :-1]], dim=1)
    dr = torch.matmul(h_prev.reshape(B * S, d).T, dpre.reshape(B * S, 4 * d))
    return dpre, dr, ((dc, dn, dh_rec, dm) if state is not None else None)
