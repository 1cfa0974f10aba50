"""Plain PyTorch version of the paged decode-attention kernel (counterpart
of ``repro/kernels/paged_attention/ref.py``).

Gathers each lane's pages through its block table and runs exact masked
softmax attention over the gathered positions, in f32.

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
