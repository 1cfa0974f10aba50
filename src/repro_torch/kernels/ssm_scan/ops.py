"""Public selective-scan entry point, with its gradient.

Dispatch is by the tensor's device: a CUDA tensor launches the kernels (or
raises), a CPU tensor runs the plain versions. When a gradient is wanted
(grad mode on and an input that requires one), the scan runs through
``_Scan``, a ``torch.autograd.Function``: on the card its forward launches
the scan kernel keeping the state after every 16-step tile, and its
backward launches the backward kernel from those states; on the CPU the
forward is ``ssm_scan_ref`` and the backward ``ssm_scan_bwd_ref``. Without
a gradient (serving) the forward keeps no states. On the card ``dt``,
``B_``, ``C_``, ``A``, ``D`` and ``h0`` go to the kernels in f32 (an upcast
from bf16 is lossless, and differentiable) and contiguous; ``u`` keeps its
dtype (f32 or bf16), which is ``y``'s and ``du``'s. Unlike the JAX wrapper
nothing is padded: the kernels bound their loops by S and ``inner``.
"""
from __future__ import annotations

from typing import Optional, Tuple

import torch

from repro_torch.kernels.ssm_scan import kernel
from repro_torch.kernels.ssm_scan.ref import ssm_scan_bwd_ref, ssm_scan_ref


class _Scan(torch.autograd.Function):
    """The scan with its gradient: kernels on the card, plain versions on the CPU."""

    @staticmethod
    def forward(ctx, u, dt, B_, C_, A, D, h0):
        ctx.set_materialize_grads(False)
        if u.is_cuda:
            y, h, chunks = kernel.ssm_scan(u, dt, B_, C_, A, D, h0, keep_chunks=True)
        else:
            (y, h), chunks = ssm_scan_ref(u, dt, B_, C_, A, D, h0), None
        ctx.save_for_backward(u, dt, B_, C_, A, D, h0, chunks)
        return y, h

    @staticmethod
    def backward(ctx, dy, dh):
        u, dt, B_, C_, A, D, h0, chunks = ctx.saved_tensors
        dy = torch.zeros_like(u) if dy is None else dy.to(u.dtype).contiguous()
        dh = None if dh is None else dh.float().contiguous()
        if u.is_cuda:
            return kernel.ssm_scan_bwd(u, dt, B_, C_, A, D, h0, chunks, dy, dh)
        return ssm_scan_bwd_ref(u, dt, B_, C_, A, D, h0, dy, dh)


def ssm_scan(
    u: torch.Tensor,        # (B, S, inner)
    dt: torch.Tensor,       # (B, S, inner)
    B_: torch.Tensor,       # (B, S, N)
    C_: torch.Tensor,       # (B, S, N)
    A: torch.Tensor,        # (inner, N)
    D: torch.Tensor,        # (inner,)
    h0: Optional[torch.Tensor] = None,   # (B, inner, N)
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Returns (y (B,S,inner) in u.dtype, h_final (B,inner,N) f32)."""
    if u.device.type not in ("cuda", "cpu"):
        raise ValueError(f"ssm_scan: unsupported device {u.device}")
    if u.is_cuda:
        f32 = lambda t: t.float().contiguous()
        u, dt, B_, C_, A, D = u.contiguous(), f32(dt), f32(B_), f32(C_), f32(A), f32(D)
        h0 = None if h0 is None else f32(h0)
    args = (u, dt, B_, C_, A, D, h0)
    if torch.is_grad_enabled() and any(t is not None and t.requires_grad for t in args):
        return _Scan.apply(*args)
    if u.is_cuda:
        return kernel.ssm_scan(*args)
    return ssm_scan_ref(*args)
