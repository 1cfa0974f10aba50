"""Public paged decode-attention entry points.

Dispatch is by the tensor's device (``kernels.on_card``): a CUDA tensor
launches the kernel (or raises), a meta tensor takes the same route and
launches nothing, a CPU tensor runs the plain version:
``paged_decode_attention`` over a bf16 or f32 pool (``paged_attention_ref``),
``paged_decode_attention_int8`` over an int8 pool of codes and scales
(``paged_attention_int8_ref``). The layout contract is in ``ref.py``.
"""
from __future__ import annotations

import torch

from repro_torch.kernels import on_card
from repro_torch.kernels.paged_attention import kernel
from repro_torch.kernels.paged_attention.ref import paged_attention_int8_ref, paged_attention_ref


def cost(B, H, KVH, hd, tokens, pages, el=2) -> tuple:
    """(operations, bytes) of one decode step over ``tokens`` cached
    positions in ``pages`` pages: q K^T and P V (4 flops a position, head
    and dim), q read and the output written, each cached k and v read
    once (``el`` bytes an element), the pages' table entries and the
    lengths read (int32)."""
    return (4.0 * tokens * H * hd,
            el * (2 * B * H * hd + 2 * tokens * KVH * hd) + 4.0 * (pages + B))


def int8_cost(B, H, KVH, hd, tokens, pages, el=2) -> tuple:
    """``cost`` over an int8 pool: each cached k and v element read as one
    byte, and its row's scale (one a position and kv head, ``el`` bytes,
    q's dtype) once; q, the output, the table and the lengths as in
    ``cost``."""
    return (4.0 * tokens * H * hd,
            el * 2 * B * H * hd + 2.0 * tokens * KVH * (hd + el) + 4.0 * (pages + B))


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


def paged_decode_attention_int8(
    q: torch.Tensor,            # (B, H, hd)
    k_codes: torch.Tensor,      # (P, page_size, KVH, hd) int8
    v_codes: torch.Tensor,      # (P, page_size, KVH, hd) int8
    k_scale: torch.Tensor,      # (P, page_size, KVH, 1) in q's dtype
    v_scale: torch.Tensor,      # (P, page_size, KVH, 1) in q's dtype
    block_table: torch.Tensor,  # (B, max_blocks) int32
    seq_lens: torch.Tensor,     # (B,) int32
) -> torch.Tensor:
    args = (q, k_codes, v_codes, k_scale, v_scale, block_table, seq_lens)
    if on_card(q, "paged_decode_attention_int8"):
        return kernel.paged_attention_int8(*args)
    return paged_attention_int8_ref(*args)
