"""Plain PyTorch versions of the selective-scan kernel (counterparts of
``repro/kernels/ssm_scan/ref.py``).

Sequential recurrence over S with an f32 state:
    h_t = exp(dt_t ⊙ A) ⊙ h_{t-1} + (dt_t ⊙ B_t) · u_t
    y_t = C_t · h_t + D ⊙ u_t

``ssm_scan_ref`` is the plain version the CPU path runs;
``ssm_scan_lanes_ref`` follows the CUDA kernels' order of operations, so
the tests can hold that order against the JAX package.
``ssm_scan_bwd_ref`` is the plain version of the gradient: the adjoint
recurrence, run in reverse over the states of a forward pass.
"""
from __future__ import annotations

from typing import Optional, Tuple

import torch

LOG2E = 1.4426950408889634   # csrc/ssm_scan.cu pre-scales A by log2(e)
STATES_PER_LANE = 4          # csrc/ssm_scan.cu's SPL


def ssm_scan_ref(
    u: torch.Tensor,        # (B, S, inner)
    dt: torch.Tensor,       # (B, S, inner)
    B_: torch.Tensor,       # (B, S, N)
    C_: torch.Tensor,       # (B, S, N)
    A: torch.Tensor,        # (inner, N)  negative decay rates
    D: torch.Tensor,        # (inner,)
    h0: Optional[torch.Tensor] = None,   # (B, inner, N)
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Returns (y (B,S,inner) in u.dtype, h_final (B,inner,N) f32)."""
    Bb, S, inner = u.shape
    N = A.shape[1]
    Af, Df = A.float(), D.float()
    h = (torch.zeros((Bb, inner, N), dtype=torch.float32, device=u.device)
         if h0 is None else h0.float())
    ys = []
    for t in range(S):
        ut, dtt = u[:, t].float(), dt[:, t].float()
        da = torch.exp(dtt[..., None] * Af)                       # (B, inner, N)
        db = dtt[..., None] * B_[:, t].float()[:, None, :]
        h = da * h + db * ut[..., None]
        y = torch.einsum("bin,bn->bi", h, C_[:, t].float())
        ys.append(y + Df * ut)
    return torch.stack(ys, dim=1).to(u.dtype), h


def ssm_scan_lanes_ref(
    u: torch.Tensor,        # (B, S, inner)
    dt: torch.Tensor,       # (B, S, inner)
    B_: torch.Tensor,       # (B, S, N)
    C_: torch.Tensor,       # (B, S, N)
    A: torch.Tensor,        # (inner, N)
    D: torch.Tensor,        # (inner,)
    h0: Optional[torch.Tensor] = None,   # (B, inner, N)
) -> Tuple[torch.Tensor, torch.Tensor]:
    """The scan in ``csrc/ssm_scan.cu``'s order (both of its kernels), in
    f32: a channel's N states split over N / 4 lanes of ``STATES_PER_LANE``
    states; per step dt·u once, the decay 2^(dt·(A·log2 e)), the state
    da·h + B·(dt·u); y summed over each lane's states in order, then over
    the lanes with xor offsets L/2 down to 1 (lane 0's sum), then + D·u.
    Returns (y in u.dtype, h_final f32)."""
    Bb, S, inner = u.shape
    N = A.shape[1]
    lanes = N // STATES_PER_LANE
    a2 = A.float() * LOG2E
    h = (torch.zeros((Bb, inner, N), dtype=torch.float32, device=u.device)
         if h0 is None else h0.float())
    ys = []
    for t in range(S):
        dtt, ut = dt[:, t].float(), u[:, t].float()
        dtu = dtt * ut
        h = torch.exp2(dtt[..., None] * a2) * h + B_[:, t].float()[:, None, :] * dtu[..., None]
        p = (h * C_[:, t].float()[:, None, :]).view(Bb, inner, lanes, STATES_PER_LANE)
        acc = p[..., 0]
        for j in range(1, STATES_PER_LANE):
            acc = acc + p[..., j]
        off = lanes // 2
        while off:
            acc = acc + acc[..., torch.arange(lanes, device=u.device) ^ off]
            off //= 2
        ys.append(acc[..., 0] + D.float() * ut)
    return torch.stack(ys, dim=1).to(u.dtype), h


def ssm_scan_bwd_ref(
    u: torch.Tensor,        # (B, S, inner)
    dt: torch.Tensor,       # (B, S, inner)
    B_: torch.Tensor,       # (B, S, N)
    C_: torch.Tensor,       # (B, S, N)
    A: torch.Tensor,        # (inner, N)
    D: torch.Tensor,        # (inner,)
    h0: Optional[torch.Tensor],    # (B, inner, N) or None (zeros)
    dy: torch.Tensor,       # (B, S, inner): the gradient of y
    dh: Optional[torch.Tensor] = None,   # (B, inner, N): of h_final, None = zeros
) -> Tuple[torch.Tensor, ...]:
    """The gradient of ``ssm_scan_ref`` by its adjoint recurrence, in f32.
    With da_t = exp(dt_t A) and g_t the gradient by h_t, from g = dh past
    the last step:

        g_t  = C_t dy_t + da_{t+1} g_{t+1}
        du_t = D dy_t + sum_n g_t dt_t B_t,   ddt_t = sum_n g_t (A da_t h_{t-1} + B_t u_t)
        dB_t = sum_i g_t dt_t u_t,            dC_t  = sum_i h_t dy_t
        dA   = sum_{b,t} g_t dt_t da_t h_{t-1},  dD = sum_{b,t} dy_t u_t,  dh0 = da_1 g_1

    The states come from a forward pass kept whole (never from dividing by
    da). Returns (du in u's dtype, ddt, dB_, dC_, dA, dD, dh0 or None when
    ``h0`` is None), all but du f32."""
    Bb, S, inner = u.shape
    N = A.shape[1]
    Af, Df = A.float(), D.float()
    h = (torch.zeros((Bb, inner, N), dtype=torch.float32, device=u.device)
         if h0 is None else h0.float())
    hs = [h]
    for t in range(S):
        da = torch.exp(dt[:, t].float()[..., None] * Af)
        h = da * h + dt[:, t].float()[..., None] * B_[:, t].float()[:, None, :] \
            * u[:, t].float()[..., None]
        hs.append(h)
    g = torch.zeros_like(h) if dh is None else dh.float().clone()
    du, ddt, dB, dC = [None] * S, [None] * S, [None] * S, [None] * S
    dA = torch.zeros_like(Af)
    dD = torch.zeros_like(Df)
    for t in reversed(range(S)):
        ut, dtt, dyt = u[:, t].float(), dt[:, t].float(), dy[:, t].float()
        bt, ct = B_[:, t].float()[:, None, :], C_[:, t].float()[:, None, :]
        da = torch.exp(dtt[..., None] * Af)
        g = g + ct * dyt[..., None]
        dC[t] = torch.einsum("bin,bi->bn", hs[t + 1], dyt)
        dB[t] = torch.einsum("bin,bi->bn", g, dtt * ut)
        du[t] = Df * dyt + (g * bt).sum(-1) * dtt
        ddt[t] = (g * (Af * da * hs[t] + bt * ut[..., None])).sum(-1)
        dA = dA + (g * dtt[..., None] * da * hs[t]).sum(0)
        dD = dD + (dyt * ut).sum(0)
        g = da * g
    stack = lambda xs, shape: torch.stack(xs, dim=1) if S else torch.zeros(shape, device=u.device)
    return (stack(du, (Bb, 0, inner)).to(u.dtype), stack(ddt, (Bb, 0, inner)),
            stack(dB, (Bb, 0, N)), stack(dC, (Bb, 0, N)), dA, dD,
            None if h0 is None else g)
