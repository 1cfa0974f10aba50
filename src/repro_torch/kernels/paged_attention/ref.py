"""Plain PyTorch versions of the paged decode-attention kernel (counterpart
of ``repro/kernels/paged_attention/ref.py``).

``paged_attention_ref`` gathers each lane's pages through its block table
and runs exact masked softmax attention over the gathered positions, in
f32. ``paged_attention_split_ref`` computes the same thing the way the
CUDA kernel does: per segment of ``SEGMENT_POSITIONS`` consecutive
positions a partial (max m, sum l, unnormalised acc), then a merge of the
partials in segment order. ``paged_attention_int8_ref`` is the reference's
int8 gather path (``repro/models/layers.py::decode_attention_paged``): an
int8 pool's gathered pages dequantized to q's dtype, then masked softmax
attention with p cast to q's dtype before P V, as the model's ``_sdpa``.

Layout contract (shared with kernel.py / ops.py and the CUDA source):

* ``q``           — (B, H, hd): one decode token per lane;
* ``k_pages``/``v_pages`` — (P, page_size, KVH, hd): the shared pool; a
  page holds ``page_size`` consecutive positions of ONE sequence;
* ``block_table`` — (B, max_blocks) int32: page of positions
  ``[j*page_size, (j+1)*page_size)`` of lane b; ``-1`` = unassigned
  (clamped to page 0 and masked);
* ``seq_lens``    — (B,) int32: valid positions per lane (0 = dead lane,
  whose output is exact zeros).
"""
from __future__ import annotations

from typing import Optional

import numpy as np
import torch

NEG_INF = -1e30
SEGMENT_POSITIONS = 128   # positions per segment of the kernel's split (csrc SEG)


def paged_attention_ref(
    q: torch.Tensor,            # (B, H, hd)
    k_pages: torch.Tensor,      # (P, page_size, KVH, hd)
    v_pages: torch.Tensor,      # (P, page_size, KVH, hd)
    block_table: torch.Tensor,  # (B, max_blocks) int32
    seq_lens: torch.Tensor,     # (B,) int32
    *,
    sm_scale: Optional[float] = None,
) -> torch.Tensor:
    B, H, hd = q.shape
    page_size, KVH = k_pages.shape[1], k_pages.shape[2]
    max_blocks = block_table.shape[1]
    G = H // KVH
    T = max_blocks * page_size
    scale = sm_scale if sm_scale is not None else float(1.0 / np.sqrt(hd))

    tbl = torch.clamp(block_table, min=0).long()            # clamp -1
    k = k_pages[tbl].reshape(B, T, KVH, hd)                 # (B, nb, ps, ...) gathered
    v = v_pages[tbl].reshape(B, T, KVH, hd)

    qg = q.reshape(B, KVH, G, hd).float()
    s = torch.einsum("bkgd,btkd->bkgt", qg, k.float()) * scale   # (B, KVH, G, T)
    kv_pos = torch.arange(T, dtype=torch.int32, device=q.device)
    valid = kv_pos[None, :] < seq_lens[:, None]                  # (B, T)
    s = torch.where(valid[:, None, None, :], s, NEG_INF)
    p = torch.softmax(s, dim=-1)
    o = torch.einsum("bkgt,btkd->bkgd", p, v.float())
    # dead lanes (seq_len 0): softmax over an all-masked row is uniform, so
    # zero the output explicitly, as the kernel's finalize does
    o = torch.where(seq_lens[:, None, None, None] > 0, o, 0.0)
    return o.reshape(B, H, hd).to(q.dtype)


def paged_attention_split_ref(
    q: torch.Tensor,            # (B, H, hd)
    k_pages: torch.Tensor,      # (P, page_size, KVH, hd)
    v_pages: torch.Tensor,      # (P, page_size, KVH, hd)
    block_table: torch.Tensor,  # (B, max_blocks) int32
    seq_lens: torch.Tensor,     # (B,) int32
    *,
    sm_scale: Optional[float] = None,
    segment: int = SEGMENT_POSITIONS,
) -> torch.Tensor:
    """Split-and-merge form, in f32: segment j holds positions [j*L, (j+1)*L)
    with L = ``segment`` (the kernel's unless a test sets another; a page may
    span segments). Its partial over its live positions is (m_j = max s,
    l_j = sum exp(s - m_j), acc_j = sum exp(s - m_j) v); an empty segment's
    is (-1e30, 0, 0). The merge takes the live segments in
    order: M = max m_j, o = sum exp(m_j - M) acc_j / max(sum exp(m_j - M)
    l_j, 1e-37); a dead lane has no live segment and gives zeros."""
    B, H, hd = q.shape
    P, page_size, KVH = k_pages.shape[0], k_pages.shape[1], k_pages.shape[2]
    max_blocks = block_table.shape[1]
    G = H // KVH
    T = max_blocks * page_size
    L = segment
    n_seg = -(-T // L)
    scale = sm_scale if sm_scale is not None else float(1.0 / np.sqrt(hd))

    tbl = torch.clamp(block_table.long(), 0, P - 1)
    k = k_pages[tbl].reshape(B, T, KVH, hd).float()
    v = v_pages[tbl].reshape(B, T, KVH, hd).float()
    qg = q.reshape(B, KVH, G, hd).float() * scale
    lens = torch.clamp(seq_lens.long(), max=T)
    out = torch.zeros((B, KVH, G, hd), dtype=torch.float32, device=q.device)
    for b in range(B):
        n = int(lens[b])
        parts = []
        for j in range(n_seg):
            lo, hi = j * L, min(n, (j + 1) * L)
            if hi <= lo:
                break   # this and later segments are empty: the merge reads none of them
            s = torch.einsum("kgd,tkd->kgt", qg[b], k[b, lo:hi])      # (KVH, G, t)
            m = s.max(dim=-1).values
            p = torch.exp(s - m[..., None])
            parts.append((m, p.sum(-1), torch.einsum("kgt,tkd->kgd", p, v[b, lo:hi])))
        if not parts:
            continue   # a dead lane stays exact zeros
        M = torch.stack([m for m, _, _ in parts]).max(dim=0).values
        l_sum = torch.zeros_like(M)
        acc = torch.zeros((KVH, G, hd), dtype=torch.float32, device=q.device)
        for m, l, a in parts:
            w = torch.exp(m - M)
            l_sum = l_sum + l * w
            acc = acc + a * w[..., None]
        out[b] = acc / torch.clamp(l_sum, min=1e-37)[..., None]
    return out.reshape(B, H, hd).to(q.dtype)


def paged_attention_int8_ref(
    q: torch.Tensor,            # (B, H, hd)
    k_codes: torch.Tensor,      # (P, page_size, KVH, hd) int8
    v_codes: torch.Tensor,      # (P, page_size, KVH, hd) int8
    k_scale: torch.Tensor,      # (P, page_size, KVH, 1) in q's dtype
    v_scale: torch.Tensor,      # (P, page_size, KVH, 1) in q's dtype
    block_table: torch.Tensor,  # (B, max_blocks) int32
    seq_lens: torch.Tensor,     # (B,) int32
) -> torch.Tensor:
    """One token per lane against an int8 pool, exactly as the reference's
    gather path: the table's pages (``-1`` read as page 0, masked by
    ``seq_lens``) gathered, dequantized to q's dtype, then masked softmax
    attention. A dead lane gives the mean of its gathered rows, which the
    engine never reads (the kernel writes zeros there). -> (B, H, hd)."""
    from repro_torch.models.layers import _dequantize_kv, _sdpa

    B, H, hd = q.shape
    P, ps, KVH = k_codes.shape[:3]
    tbl = torch.clamp(block_table, min=0).long()
    T = tbl.shape[1] * ps
    k = _dequantize_kv(k_codes[tbl], k_scale[tbl], q.dtype)
    v = _dequantize_kv(v_codes[tbl], v_scale[tbl], q.dtype)
    qg = q.reshape(B, 1, KVH, H // KVH, hd)
    kv_pos = torch.arange(T, dtype=torch.int32, device=q.device)
    mask = (kv_pos[None, :] < seq_lens[:, None])[:, None, :]      # (B, 1, T)
    out = _sdpa(qg, k.reshape(B, T, KVH, hd), v.reshape(B, T, KVH, hd), mask,
                float(1.0 / np.sqrt(hd)))
    return out.reshape(B, H, hd)
