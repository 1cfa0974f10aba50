"""Public flash-attention entry point, in the model's (B, S, H, hd) layout.

Same signature and layout as ``repro.kernels.flash_attention.ops``, whose
``custom_vjp`` becomes a ``torch.autograd.Function``: the forward saves
only (q, k, v, o, lse), O(S * hd), never the S x S probabilities, and the
backward recomputes them tile by tile. The CUDA kernels read the model's
layout through strides, so there is no head-major transpose and no
padding: ragged tails are masked in the kernels.

Dispatch is by the tensor's device (``kernels.on_card``): a CUDA tensor
launches the kernels (forward ``kernel.py``, backward ``kernel_bwd.py``) or
raises, a meta tensor takes the same route and launches nothing; a CPU
tensor runs the plain ``attention_fwd_ref`` / ``attention_bwd_ref``.

``fwd_cost``, ``dkdv_cost`` and ``dq_cost`` are the kernels' least work,
(operations, bytes): the products over the live (q, k) pairs, 2 flops a
multiply-add (the forward QK^T and PV; dk/dv the products s, dp, dv, dk;
dq its one), each input read once and each output written once.
"""
from __future__ import annotations

import torch

from repro_torch.kernels import live_pairs, on_card
from repro_torch.kernels.flash_attention import kernel, kernel_bwd
from repro_torch.kernels.flash_attention.ref import attention_bwd_ref, attention_fwd_ref


def _product(B, Sq, Skv, H, hd, causal, window, q_offset) -> float:
    """One (Sq x Skv x hd) product's flops over the live pairs."""
    return 2.0 * live_pairs(Sq, Skv, causal, window, q_offset) * hd * H * B


def fwd_cost(B, Sq, Skv, H, KVH, hd, causal=True, window=0, q_offset=0, el=2) -> tuple:
    """The forward: QK^T and PV; q, k, v read and o written (``el`` bytes an
    element), lse written (f32)."""
    flops = 2 * _product(B, Sq, Skv, H, hd, causal, window, q_offset)
    return flops, el * (2 * B * Sq * H * hd + 2 * B * Skv * KVH * hd) + 4.0 * B * H * Sq


def dkdv_cost(B, Sq, Skv, H, KVH, hd, causal=True, window=0, q_offset=0, el=2) -> tuple:
    """dk and dv: the products s, dp, dv, dk; q, do, k, v, lse and delta
    read, dk and dv written."""
    reads = el * (2 * B * Sq * H * hd + 2 * B * Skv * KVH * hd) + 2 * 4.0 * B * H * Sq
    return (4 * _product(B, Sq, Skv, H, hd, causal, window, q_offset),
            reads + el * 2 * B * Skv * KVH * hd)


def dq_cost(B, Sq, Skv, H, KVH, hd, causal=True, window=0, q_offset=0, el=2) -> tuple:
    """dq: its own product (the design's recompute of s and dp is its
    overhead, in its time), dq written."""
    return _product(B, Sq, Skv, H, hd, causal, window, q_offset), el * B * Sq * H * hd


class _FlashAttention(torch.autograd.Function):
    @staticmethod
    def forward(ctx, q, k, v, causal, window, q_offset):
        kw = dict(causal=causal, window=window, q_offset=q_offset)
        if on_card(q, "flash_attention"):
            o, lse = kernel.flash_attention_fwd(q, k, v, **kw)
        else:
            o, lse = attention_fwd_ref(q, k, v, **kw)
        ctx.save_for_backward(q, k, v, o, lse)
        ctx.kw = kw
        return o

    @staticmethod
    def backward(ctx, do):
        q, k, v, o, lse = ctx.saved_tensors
        bwd = kernel_bwd.flash_attention_bwd if on_card(q, "flash_attention") \
            else attention_bwd_ref
        dq, dk, dv = bwd(q, k, v, o, lse, do, **ctx.kw)
        return dq, dk, dv, None, None, None


def flash_attention(
    q: torch.Tensor,       # (B, Sq, H, hd)
    k: torch.Tensor,       # (B, Skv, KVH, hd)
    v: torch.Tensor,
    causal: bool = True,
    window: int = 0,
    q_offset: int = 0,
) -> torch.Tensor:
    return _FlashAttention.apply(q, k, v, causal, window, q_offset)
