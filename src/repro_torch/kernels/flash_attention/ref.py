"""Plain PyTorch version of the flash-attention kernel (line-for-line
counterpart of ``repro/kernels/flash_attention/ref.py``).

Materializes the full (Sq x Skv) score matrix in f32: O(S^2) memory, the
exact math the CUDA kernel is held against. Causal masking, sliding
windows, ``q_offset`` and grouped-query attention.
"""
from __future__ import annotations

import numpy as np
import torch


def attention_ref(
    q: torch.Tensor,          # (B, Sq, H, hd)
    k: torch.Tensor,          # (B, Skv, KVH, hd)
    v: torch.Tensor,          # (B, Skv, KVH, hd)
    *,
    causal: bool = True,
    window: int = 0,
    q_offset: int = 0,
    sm_scale: float | None = None,
) -> torch.Tensor:
    B, Sq, H, hd = q.shape
    Skv, KVH = k.shape[1], k.shape[2]
    G = H // KVH
    scale = sm_scale if sm_scale is not None else float(1.0 / np.sqrt(hd))

    qg = q.reshape(B, Sq, KVH, G, hd)
    s = torch.einsum("bqhgd,bkhd->bhgqk", qg.float(), k.float())
    s = s * scale

    q_pos = q_offset + torch.arange(Sq, device=q.device)
    kv_pos = torch.arange(Skv, device=q.device)
    mask = torch.ones((Sq, Skv), dtype=torch.bool, device=q.device)
    if causal:
        mask &= q_pos[:, None] >= kv_pos[None, :]
    if window:
        mask &= q_pos[:, None] - kv_pos[None, :] < window
    s = s.masked_fill(~mask, float("-inf"))

    p = torch.softmax(s, dim=-1)
    o = torch.einsum("bhgqk,bkhd->bqhgd", p, v.float())
    return o.reshape(B, Sq, H, hd).to(q.dtype)
