"""Public chunkwise-mLSTM entry point, in the model's layout.

Dispatch is by the tensor's device (``kernels.on_card``): a CUDA tensor
launches the kernel (or raises), a meta tensor takes the same route and
launches nothing, a CPU tensor runs the plain ``mlstm_chunkwise_ref`` at
the model's ``chunk``. On the card the gates and the state go to the kernels
in f32 and contiguous; q/k/v keep their dtype (f32 or bf16), which is h's,
and may be strided views of the (B, S, inner) projections. ``kernel.mlstm``
picks the kernel (a decode step of a few timesteps: one pass over C;
longer: the chunkwise kernel, on tensor cores in bf16, and as split TF32
on the tensor cores for f32 and the rest); each bounds its loops by S, so nothing is padded: the stabilizer
and the state are the same for any chunk length, up to rounding.

When grad mode is on and an input requires a gradient, the call goes
through ``_MLSTM``: on the card the chunkwise kernel (at any S) keeping
what the gradient starts from, then ``kernel.mlstm_bwd``; on the CPU
``mlstm_chunkwise_ref``, then ``mlstm_chunkwise_bwd_ref``. Serving never
takes it.
"""
from __future__ import annotations

from typing import Optional, Tuple

import torch

from repro_torch.kernels import on_card
from repro_torch.kernels.mlstm import kernel
from repro_torch.kernels.mlstm.ref import mlstm_chunkwise_bwd_ref, mlstm_chunkwise_ref


def cost(B, S, H, hd, el=2, state=False) -> tuple:
    """(operations, bytes) of the mLSTM over S steps, whichever kernel runs
    it: per token and head q C^T and the C update (2 hd^2 flops each) and
    the recurrence's O(hd) rest (4 hd; a chunked form's intra-chunk products
    are its own overhead, not the function's); q, k, v read and h written
    (``el`` bytes an element), the gates read and the state (C, n, m)
    written, and read too where one is carried in (f32)."""
    st = 4.0 * B * H * (hd * hd + hd + 1)
    return ((4.0 * hd * hd + 4.0 * hd) * B * S * H,
            el * B * S * H * hd * 4 + 4.0 * B * S * 2 * H + st * (1 + state))


def bwd_cost(B, S, H, hd, el=2) -> tuple:
    """(operations, bytes) of its gradient: 8 hd^2 + 16 hd flops a token and
    head; q, k, v, h, dh read and dq, dk, dv written (``el`` bytes), the
    gates read and their gradient written (f32). The forward's kept chunk
    states are the design's, left out."""
    return ((8.0 * hd * hd + 16.0 * hd) * B * S * H,
            el * 8.0 * B * S * H * hd + 4.0 * 2 * B * S * 2 * H)


def _f32(t: Optional[torch.Tensor]) -> Optional[torch.Tensor]:
    return None if t is None else t.float().contiguous()


class _MLSTM(torch.autograd.Function):
    """h and the final state of the chunkwise mLSTM, with its gradient. A
    final state that nothing uses gets no gradient (``materialize_grads``
    off: its dC, dn, dm arrive as None)."""

    @staticmethod
    def forward(ctx, q, k, v, gates, C0, n0, m0, chunk):
        state = None if C0 is None else (C0, n0, m0)
        ctx.set_materialize_grads(False)
        ctx.chunk, ctx.has_state, ctx.gates_dtype = chunk, state is not None, gates.dtype
        if on_card(q, "mlstm"):
            g32 = _f32(gates)
            st = None if state is None else tuple(_f32(t) for t in state)
            h, (C, n, m), kept = kernel.mlstm_chunkwise(q, k, v, g32, st, keep=True)
            ctx.save_for_backward(q, k, v, g32, h, C, n, *kept)
        else:
            h, (C, n, m) = mlstm_chunkwise_ref(q, k, v, gates, state, chunk)
            ctx.save_for_backward(q, k, v, gates, h, *(state or ()))
        return h, C, n, m

    @staticmethod
    def backward(ctx, dh, dC, dn, dm):
        saved = ctx.saved_tensors            # unpacked once (checkpoint allows no second)
        q, k, v, gates, h = saved[:5]
        if dh is None:
            dh = torch.zeros_like(h)
        if on_card(q, "mlstm"):
            C, n, *kept = saved[5:]
            dq, dk, dv, dg, dstate = kernel.mlstm_bwd(
                q, k, v, gates, h, dh.to(h.dtype).contiguous(), tuple(kept), (C, n),
                (dC, dn, dm), want_dstate=ctx.has_state)
        else:
            state = saved[5:]
            dq, dk, dv, dg, dstate = mlstm_chunkwise_bwd_ref(
                q, k, v, gates, tuple(state) or None, h, dh, (dC, dn, dm), ctx.chunk)
        dstate = dstate if dstate is not None else (None, None, None)
        return dq, dk, dv, dg.to(ctx.gates_dtype), *dstate, None


def mlstm(
    q: torch.Tensor,       # (B, S, H, hd)
    k: torch.Tensor,
    v: torch.Tensor,
    gates: torch.Tensor,   # (B, S, 2H)
    state: Optional[Tuple[torch.Tensor, torch.Tensor, torch.Tensor]] = None,
    chunk: int = 64,
) -> Tuple[torch.Tensor, Tuple[torch.Tensor, torch.Tensor, torch.Tensor]]:
    """Returns (h (B,S,H,hd) in q's dtype, (C (B,H,hd,hd), n (B,H,hd), m (B,H)) f32)."""
    card = on_card(q, "mlstm")
    if torch.is_grad_enabled() and any(
            t is not None and t.requires_grad for t in (q, k, v, gates, *(state or ()))):
        h, C, n, m = _MLSTM.apply(q, k, v, gates, *(state or (None,) * 3), chunk)
        return h, (C, n, m)
    if card:
        return kernel.mlstm(q, k, v, _f32(gates),
                            None if state is None else tuple(_f32(t) for t in state))
    return mlstm_chunkwise_ref(q, k, v, gates, state, chunk)
