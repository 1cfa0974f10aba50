"""Public selective-scan entry point.

Dispatch is by the tensor's device: a CUDA tensor launches the kernel (or
raises), a CPU tensor runs the plain ``ssm_scan_ref``. On the card ``dt``,
``B_``, ``C_``, ``A``, ``D`` and ``h0`` go to the kernel in f32 (an upcast
from bf16 is lossless) and contiguous; ``u`` keeps its dtype (f32 or
bf16), which is ``y``'s. Unlike the JAX wrapper nothing is padded: the
kernel bounds its loops by S and ``inner``.
"""
from __future__ import annotations

from typing import Optional, Tuple

import torch

from repro_torch.kernels.ssm_scan import kernel
from repro_torch.kernels.ssm_scan.ref import ssm_scan_ref


def ssm_scan(
    u: torch.Tensor,        # (B, S, inner)
    dt: torch.Tensor,       # (B, S, inner)
    B_: torch.Tensor,       # (B, S, N)
    C_: torch.Tensor,       # (B, S, N)
    A: torch.Tensor,        # (inner, N)
    D: torch.Tensor,        # (inner,)
    h0: Optional[torch.Tensor] = None,   # (B, inner, N)
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Returns (y (B,S,inner) in u's dtype, h_final (B,inner,N) f32)."""
    if u.device.type == "cuda":
        f32 = lambda t: t.float().contiguous()
        return kernel.ssm_scan(u.contiguous(), f32(dt), f32(B_), f32(C_), f32(A), f32(D),
                               None if h0 is None else f32(h0))
    if u.device.type == "cpu":
        return ssm_scan_ref(u, dt, B_, C_, A, D, h0)
    raise ValueError(f"ssm_scan: unsupported device {u.device}")
