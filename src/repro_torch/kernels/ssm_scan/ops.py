"""Public selective-scan entry point, with its gradient.

Dispatch is by the tensor's device (``kernels.on_card``): a CUDA tensor
launches the kernels (or raises), a meta tensor takes the same route and
launches nothing, a CPU tensor runs the plain versions. When a gradient is wanted
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

from repro_torch.kernels import on_card
from repro_torch.kernels.ssm_scan import kernel
from repro_torch.kernels.ssm_scan.ref import ssm_scan_bwd_ref, ssm_scan_ref


def cost(B, S, inner, N, el=4, h0=True) -> tuple:
    """(operations, bytes) of the scan: per (b, t, i, n) dt*A, exp, dt*B,
    da*h, db*u, +, h*C, + (8 flops), per (b, t, i) D*u, + (2); u read and y
    written (``el`` bytes an element), dt, B_, C_, A, D read, h written and
    h0 read where given (f32)."""
    return (8.0 * B * S * inner * N + 2.0 * B * S * inner,
            el * 2.0 * B * S * inner + 4.0 * (B * S * inner + 2 * B * S * N + inner * N + inner
                                              + (1 + h0) * B * inner * N))


def bwd_cost(B, S, inner, N, el=4) -> tuple:
    """(operations, bytes) of its gradient: 20 f32 flops a (b, t, i, n); u,
    dy read and du written (``el`` bytes), dt read and ddt written, B_, C_
    read and their gradients written, A, D read and their gradients
    written (f32). The forward's kept states are the design's, left out."""
    return (20.0 * B * S * inner * N,
            (2 * el + 4.0 * 2) * B * S * inner + 4.0 * 4 * B * S * N
            + 4.0 * 2 * (inner * N + inner))


class _Scan(torch.autograd.Function):
    """The scan with its gradient: kernels on the card, plain versions on the CPU."""

    @staticmethod
    def forward(ctx, u, dt, B_, C_, A, D, h0):
        ctx.set_materialize_grads(False)
        if on_card(u, "ssm_scan"):
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
        if on_card(u, "ssm_scan"):
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
    card = on_card(u, "ssm_scan")
    if card:
        f32 = lambda t: t.float().contiguous()
        u, dt, B_, C_, A, D = u.contiguous(), f32(dt), f32(B_), f32(C_), f32(A), f32(D)
        h0 = None if h0 is None else f32(h0)
    args = (u, dt, B_, C_, A, D, h0)
    if torch.is_grad_enabled() and any(t is not None and t.requires_grad for t in args):
        return _Scan.apply(*args)
    if card:
        return kernel.ssm_scan(*args)
    return ssm_scan_ref(*args)
