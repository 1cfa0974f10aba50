"""Plain PyTorch version of the selective-scan kernel (counterpart of
``repro/kernels/ssm_scan/ref.py``).

Sequential recurrence over S with an f32 state:
    h_t = exp(dt_t ⊙ A) ⊙ h_{t-1} + (dt_t ⊙ B_t) · u_t
    y_t = C_t · h_t + D ⊙ u_t
"""
from __future__ import annotations

from typing import Optional, Tuple

import torch


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
