"""Public sLSTM recurrence entry point.

Dispatch is by the tensor's device (``kernels.on_card``): a CUDA tensor
launches the kernel (or raises), a meta tensor takes the same route and
launches nothing, a CPU tensor runs the plain ``slstm_ref``. On the card wx, r and
the state go to the kernel in f32 and contiguous (all are f32 on the
model's path).

When grad mode is on and an input requires a gradient, the call goes
through ``_SLSTM``: on the card the forward kernel keeping what the
gradient starts from, then ``kernel.slstm_bwd``; on the CPU ``slstm_ref``,
then ``slstm_bwd_ref``. Serving never takes it.
"""
from __future__ import annotations

from typing import Optional, Tuple

import torch

from repro_torch.kernels import on_card
from repro_torch.kernels.slstm import kernel
from repro_torch.kernels.slstm.ref import State, slstm_bwd_ref, slstm_ref


def cost(B, S, d) -> tuple:
    """(operations, bytes) of the recurrence: h_{t-1} r, 2 B d 4d f32 flops a
    step; wx read and hs written, r read, the start state read and the
    final one written, once each (f32)."""
    return 2.0 * B * S * d * 4 * d, 4.0 * (B * S * 4 * d + B * S * d + d * 4 * d + 8 * B * d)


def bwd_cost(B, S, d, dr: bool = True) -> tuple:
    """(operations, bytes) of its gradient: dpre r^T, and with ``dr`` the
    product h_prev^T dpre, 2 B S d 4d flops each; r, hs, dhs and what the
    forward kept (pre, c, n, m) read, dpre and dr written (f32). The
    kernel leaves dr to one product in its wrapper: its launch is counted
    with ``dr=False``, and the product as the product it is."""
    return ((1 + dr) * 2.0 * B * S * d * 4 * d,
            4.0 * (d * 4 * d + B * S * (d + d + 4 * d + 3 * d) + B * S * 4 * d + dr * d * 4 * d))


def _f32(t: Optional[torch.Tensor]) -> Optional[torch.Tensor]:
    return None if t is None else t.float().contiguous()


class _SLSTM(torch.autograd.Function):
    """hs and the final state of the sLSTM, with its gradient. A final
    state that nothing uses gets no gradient (``materialize_grads`` off:
    its dc, dn, dh, dm arrive as None)."""

    @staticmethod
    def forward(ctx, wx, r, c0, n0, h0, m0):
        state = None if c0 is None else (c0, n0, h0, m0)
        ctx.set_materialize_grads(False)
        ctx.has_state = state is not None
        if on_card(wx, "slstm"):
            r32 = _f32(r)
            st = None if state is None else tuple(_f32(t) for t in state)
            hs, (c, n, h, m), kept = kernel.slstm(_f32(wx), r32, st, keep=True)
        else:
            r32, st = r, state
            hs, (c, n, h, m), kept = slstm_ref(wx, r, state, keep=True)
        ctx.save_for_backward(r32, hs, *kept, *(st or ()))
        return hs, c, n, h, m

    @staticmethod
    def backward(ctx, dhs, dc, dn, dh, dm):
        saved = ctx.saved_tensors            # unpacked once (checkpoint allows no second)
        r, hs, kept, state = saved[0], saved[1], tuple(saved[2:6]), tuple(saved[6:]) or None
        dstate = (dc, dn, dh, dm)
        if on_card(hs, "slstm"):
            dwx, dr, dstate0 = kernel.slstm_bwd(r, state, hs, kept, _f32(dhs),
                                                tuple(_f32(t) for t in dstate))
        else:
            dwx, dr, dstate0 = slstm_bwd_ref(r, state, hs, kept, dhs, dstate)
        return (dwx, dr, *(dstate0 if dstate0 is not None else (None,) * 4))


def slstm(
    wx: torch.Tensor,                 # (B, S, 4d) f32
    r: torch.Tensor,                  # (d, 4d) f32
    state: Optional[State] = None,    # (c, n, h, m) f32 (B, d) each; None: zeros
) -> Tuple[torch.Tensor, State]:
    """Returns (hs (B, S, d), (c, n, h, m)) f32."""
    card = on_card(wx, "slstm")
    if torch.is_grad_enabled() and any(
            t is not None and t.requires_grad for t in (wx, r, *(state or ()))):
        hs, c, n, h, m = _SLSTM.apply(wx, r, *(state or (None,) * 4))
        return hs, (c, n, h, m)
    if card:
        return kernel.slstm(_f32(wx), _f32(r),
                            None if state is None else tuple(_f32(t) for t in state))
    return slstm_ref(wx, r, state)
