"""Public paged decode-attention entry point.

Dispatch is by the tensor's device (``kernels.on_card``): a CUDA tensor
launches the kernel (or raises), a meta tensor takes the same route and
launches nothing, a CPU tensor runs the plain ``paged_attention_ref``.
Pools must be bf16 or f32; the layout contract is in ``ref.py``.
"""
from __future__ import annotations

import torch

from repro_torch.kernels import on_card
from repro_torch.kernels.paged_attention import kernel
from repro_torch.kernels.paged_attention.ref import paged_attention_ref


def cost(B, H, KVH, hd, tokens, pages, el=2) -> tuple:
    """(operations, bytes) of one decode step over ``tokens`` cached
    positions in ``pages`` pages: q K^T and P V (4 flops a position, head
    and dim), q read and the output written, each cached k and v read
    once (``el`` bytes an element), the pages' table entries and the
    lengths read (int32)."""
    return (4.0 * tokens * H * hd,
            el * (2 * B * H * hd + 2 * tokens * KVH * hd) + 4.0 * (pages + B))


def paged_decode_attention(
    q: torch.Tensor,            # (B, H, hd)
    k_pages: torch.Tensor,      # (P, page_size, KVH, hd)
    v_pages: torch.Tensor,      # (P, page_size, KVH, hd)
    block_table: torch.Tensor,  # (B, max_blocks) int32
    seq_lens: torch.Tensor,     # (B,) int32
) -> torch.Tensor:
    if on_card(q, "paged_decode_attention"):
        return kernel.paged_attention(q, k_pages, v_pages, block_table, seq_lens)
    return paged_attention_ref(q, k_pages, v_pages, block_table, seq_lens)
