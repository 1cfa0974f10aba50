"""Public flash-attention entry point, in the model's (B, S, H, hd) layout.

Same signature and layout as ``repro.kernels.flash_attention.ops``, whose
``custom_vjp`` becomes a ``torch.autograd.Function``: the forward saves
only (q, k, v, o, lse), O(S * hd), never the S x S probabilities, and the
backward recomputes them tile by tile. The CUDA kernels read the model's
layout through strides, so there is no head-major transpose and no
padding: ragged tails are masked in the kernels.

Dispatch is by the tensor's device: a CUDA tensor launches the kernels
(forward ``kernel.py``, backward ``kernel_bwd.py``) or raises; a CPU
tensor runs the plain ``attention_fwd_ref`` / ``attention_bwd_ref``.
"""
from __future__ import annotations

import torch

from repro_torch.kernels.flash_attention import kernel, kernel_bwd
from repro_torch.kernels.flash_attention.ref import attention_bwd_ref, attention_fwd_ref


def _device_type(q: torch.Tensor) -> str:
    if q.device.type not in ("cuda", "cpu"):
        raise ValueError(f"flash_attention: unsupported device {q.device}")
    return q.device.type


class _FlashAttention(torch.autograd.Function):
    @staticmethod
    def forward(ctx, q, k, v, causal, window, q_offset):
        kw = dict(causal=causal, window=window, q_offset=q_offset)
        if _device_type(q) == "cuda":
            o, lse = kernel.flash_attention_fwd(q, k, v, **kw)
        else:
            o, lse = attention_fwd_ref(q, k, v, **kw)
        ctx.save_for_backward(q, k, v, o, lse)
        ctx.kw = kw
        return o

    @staticmethod
    def backward(ctx, do):
        q, k, v, o, lse = ctx.saved_tensors
        bwd = kernel_bwd.flash_attention_bwd if _device_type(q) == "cuda" else attention_bwd_ref
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
