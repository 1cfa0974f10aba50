"""Plain PyTorch versions of the selective-scan kernel (counterparts of
``repro/kernels/ssm_scan/ref.py``).

Sequential recurrence over S with an f32 state:
    h_t = exp(dt_t ⊙ A) ⊙ h_{t-1} + (dt_t ⊙ B_t) · u_t
    y_t = C_t · h_t + D ⊙ u_t

``ssm_scan_ref`` is the plain version the CPU path runs;
``ssm_scan_lanes_ref`` follows the CUDA kernels' order of operations, so
the tests can hold that order against the JAX package.
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
