"""Public paged decode-attention entry point.

Dispatch is by the tensor's device: a CUDA tensor launches the kernel (or
raises), a CPU tensor runs the plain ``paged_attention_ref``. Pools must
be bf16 or f32; the layout contract is in ``ref.py``.
"""
from __future__ import annotations

import torch

from repro_torch.kernels.paged_attention import kernel
from repro_torch.kernels.paged_attention.ref import paged_attention_ref


def paged_decode_attention(
    q: torch.Tensor,            # (B, H, hd)
    k_pages: torch.Tensor,      # (P, page_size, KVH, hd)
    v_pages: torch.Tensor,      # (P, page_size, KVH, hd)
    block_table: torch.Tensor,  # (B, max_blocks) int32
    seq_lens: torch.Tensor,     # (B,) int32
) -> torch.Tensor:
    if q.device.type == "cuda":
        return kernel.paged_attention(q, k_pages, v_pages, block_table, seq_lens)
    if q.device.type == "cpu":
        return paged_attention_ref(q, k_pages, v_pages, block_table, seq_lens)
    raise ValueError(f"paged_decode_attention: unsupported device {q.device}")
