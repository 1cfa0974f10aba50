"""Launch wrapper of the CUDA paged decode attention
(``csrc/paged_attention.cu``, replacing the Pallas ``_paged_kernel``).

``paged_attention`` validates what the kernel takes, allocates the output
and the split kernel's f32 workspace (PyTorch's caching allocator),
launches the split and merge kernels on PyTorch's current stream and
counts the call by variant, chosen by q's dtype: bf16 scores and P·V on
tensor cores (``launches_tc``), f32 on FMAs (``launches_fma``).
``paged_attention_int8`` does the same over an int8 pool (codes, and one
scale per row and kv head in q's dtype), which the kernels dequantize as
they stage each tile (``launches_int8_tc``, ``launches_int8_fma``). Neither
reads ``seq_lens`` or ``block_table`` on the host, so neither synchronises.
Neither falls back: anything the kernel does not take raises.
"""
from __future__ import annotations

from typing import Optional

import numpy as np
import torch

from repro_torch.kernels import _build
from repro_torch.kernels.paged_attention.ref import SEGMENT_POSITIONS

launches_tc = 0     # calls since the last reset (plain ints), by variant
launches_fma = 0
launches_int8_tc = 0
launches_int8_fma = 0

HEAD_DIMS = (32, 64, 128, 256)
GROUPS = (1, 2, 4, 8)
GROUPS_HD256 = (1, 2, 4)   # the f32 kernel's P.V phase gives each (head, 8 columns) a thread


def _check(q, k_pages, v_pages, block_table, seq_lens, scales=()) -> None:
    """Raise unless the kernel takes these inputs; ``scales`` (k and v) mark
    an int8 pool."""
    dev = q.device
    tensors = (q, k_pages, v_pages, *scales, block_table, seq_lens)
    if dev.type not in ("cuda", "meta") or any(t.device != dev for t in tensors):
        raise ValueError("paged_attention kernel: all inputs must be on one CUDA (or meta) "
                         "device")
    pool = torch.int8 if scales else q.dtype
    if q.dtype not in _build.DTYPE_CODE or k_pages.dtype != pool or v_pages.dtype != pool or \
            any(s.dtype != q.dtype for s in scales):
        raise ValueError(f"paged_attention kernel: dtype {q.dtype}/{k_pages.dtype}"
                         + (f"/{scales[0].dtype}" if scales else "")
                         + " (q one of float32, bfloat16; the pools q's dtype, or int8 codes "
                           "with scales in q's dtype through paged_attention_int8)")
    if block_table.dtype != torch.int32 or seq_lens.dtype != torch.int32:
        raise ValueError("paged_attention kernel: block_table and seq_lens must be int32")
    B, H, hd = q.shape
    P, ps, KVH, hd_k = k_pages.shape
    if hd != hd_k or v_pages.shape != k_pages.shape or H % KVH or any(
            tuple(s.shape) != (P, ps, KVH, 1) for s in scales):
        raise ValueError(f"paged_attention kernel: q{tuple(q.shape)} pools{tuple(k_pages.shape)}"
                         + "".join(f" scale{tuple(s.shape)}" for s in scales))
    if block_table.dim() != 2 or block_table.shape[0] != B or tuple(seq_lens.shape) != (B,):
        raise ValueError(f"paged_attention kernel: table{tuple(block_table.shape)} "
                         f"lens{tuple(seq_lens.shape)} for {B} lanes")
    groups = GROUPS_HD256 if hd == 256 else GROUPS
    if hd not in HEAD_DIMS or H // KVH not in groups:
        raise ValueError(f"paged_attention kernel: head_dim {hd} (one of {HEAD_DIMS}), "
                         f"group {H // KVH} (one of {groups} at this head_dim)")
    if not all(t.is_contiguous() for t in tensors) or any(
        t.data_ptr() % 16 for t in (q, k_pages, v_pages)
    ):
        raise ValueError("paged_attention kernel: inputs must be contiguous and 16-byte aligned")


def _launch(q, k_pages, v_pages, scales, block_table, seq_lens, sm_scale) -> tuple:
    """Check, allocate and launch one call; returns (out, launched)."""
    _check(q, k_pages, v_pages, block_table, seq_lens, scales)
    B, H, hd = q.shape
    P, ps, KVH, _ = k_pages.shape
    nb = block_table.shape[1]
    scale = sm_scale if sm_scale is not None else float(1.0 / np.sqrt(hd))
    out = torch.empty_like(q)
    if B == 0 or nb == 0:
        return out.zero_(), False
    n_seg = -(-nb * ps // SEGMENT_POSITIONS)
    # per (lane, kv head, segment, query head): acc[hd], then m, then l
    ws = torch.empty(B * KVH * n_seg * (H // KVH) * (hd + 2), dtype=torch.float32,
                     device=q.device)
    variant = "tc" if q.dtype == torch.bfloat16 else "fma"
    entry, kernel = "repro_paged_attention", f"paged_attention_{variant}"
    if scales:
        entry, kernel = "repro_paged_attention_int8", f"paged_attention_int8_{variant}"
    # the meta device has no seq_lens to read: its cost counts every slot of
    # the block table (the most a call can read)
    launched = _build.launch(
        entry, kernel, q.device,
        (q.data_ptr(), k_pages.data_ptr(), v_pages.data_ptr(),
         *(s.data_ptr() for s in scales),
         block_table.data_ptr(), seq_lens.data_ptr(), out.data_ptr(), ws.data_ptr(),
         _build.DTYPE_CODE[q.dtype], B, H, KVH, hd, P, ps, nb, n_seg,
         float(scale), _build.STREAM),
        B=B, H=H, KVH=KVH, hd=hd, tokens=B * nb * ps, pages=B * nb, el=q.element_size())
    return out, launched


def paged_attention(
    q: torch.Tensor,            # (B, H, hd)
    k_pages: torch.Tensor,      # (P, page_size, KVH, hd)
    v_pages: torch.Tensor,      # (P, page_size, KVH, hd)
    block_table: torch.Tensor,  # (B, max_blocks) int32
    seq_lens: torch.Tensor,     # (B,) int32
    *,
    sm_scale: Optional[float] = None,
) -> torch.Tensor:
    """Returns (B, H, hd) in q's dtype."""
    global launches_tc, launches_fma
    out, launched = _launch(q, k_pages, v_pages, (), block_table, seq_lens, sm_scale)
    if launched and q.dtype == torch.bfloat16:
        launches_tc += 1
    elif launched:
        launches_fma += 1
    return out


def paged_attention_int8(
    q: torch.Tensor,            # (B, H, hd)
    k_codes: torch.Tensor,      # (P, page_size, KVH, hd) int8
    v_codes: torch.Tensor,      # (P, page_size, KVH, hd) int8
    k_scale: torch.Tensor,      # (P, page_size, KVH, 1) in q's dtype
    v_scale: torch.Tensor,      # (P, page_size, KVH, 1) in q's dtype
    block_table: torch.Tensor,  # (B, max_blocks) int32
    seq_lens: torch.Tensor,     # (B,) int32
    *,
    sm_scale: Optional[float] = None,
) -> torch.Tensor:
    """Returns (B, H, hd) in q's dtype: the kernels' attention over the pool
    dequantized as ``_dequantize_kv`` does (f32 code times f32 scale,
    rounded to q's dtype), the bits ``paged_attention`` gives on that pool."""
    global launches_int8_tc, launches_int8_fma
    out, launched = _launch(q, k_codes, v_codes, (k_scale, v_scale), block_table, seq_lens,
                            sm_scale)
    if launched and q.dtype == torch.bfloat16:
        launches_int8_tc += 1
    elif launched:
        launches_int8_fma += 1
    return out
