"""Public flash-attention entry point, in the model's (B, S, H, hd) layout.

Same signature and layout as ``repro.kernels.flash_attention.ops``'s
forward. The CUDA kernel reads that layout through strides, so there is
no head-major transpose and no padding: the ragged kv tail is masked in
the kernel. Dispatch is by the tensor's device: a CUDA tensor launches
the kernel (or raises), a CPU tensor runs the plain ``attention_ref``.
"""
from __future__ import annotations

import torch

from repro_torch.kernels.flash_attention import kernel
from repro_torch.kernels.flash_attention.ref import attention_ref


def flash_attention(
    q: torch.Tensor,       # (B, Sq, H, hd)
    k: torch.Tensor,       # (B, Skv, KVH, hd)
    v: torch.Tensor,
    causal: bool = True,
    window: int = 0,
    q_offset: int = 0,
) -> torch.Tensor:
    if q.device.type == "cuda":
        o, _ = kernel.flash_attention_fwd(
            q, k, v, causal=causal, window=window, q_offset=q_offset
        )
        return o
    if q.device.type == "cpu":
        return attention_ref(q, k, v, causal=causal, window=window, q_offset=q_offset)
    raise ValueError(f"flash_attention: unsupported device {q.device}")
