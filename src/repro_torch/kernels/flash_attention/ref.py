"""Plain PyTorch versions of the flash-attention kernels: the forward
(line-for-line counterpart of ``repro/kernels/flash_attention/ref.py``)
and the backward (the formula of ``kernel_bwd.py``, computed densely).

Each materializes the full (Sq x Skv) score matrix in f32: O(S^2) memory,
the exact math the CUDA kernels are held against. Causal masking, sliding
windows, ``q_offset`` and grouped-query attention.
"""
from __future__ import annotations

import numpy as np
import torch


def _mask(Sq: int, Skv: int, causal: bool, window: int, q_offset: int, device):
    q_pos = q_offset + torch.arange(Sq, device=device)
    kv_pos = torch.arange(Skv, device=device)
    mask = torch.ones((Sq, Skv), dtype=torch.bool, device=device)
    if causal:
        mask &= q_pos[:, None] >= kv_pos[None, :]
    if window:
        mask &= q_pos[:, None] - kv_pos[None, :] < window
    return mask


def _scale(hd: int, sm_scale: float | None) -> float:
    return sm_scale if sm_scale is not None else float(1.0 / np.sqrt(hd))


def attention_fwd_ref(
    q: torch.Tensor,          # (B, Sq, H, hd)
    k: torch.Tensor,          # (B, Skv, KVH, hd)
    v: torch.Tensor,          # (B, Skv, KVH, hd)
    *,
    causal: bool = True,
    window: int = 0,
    q_offset: int = 0,
    sm_scale: float | None = None,
):
    """Returns (o (B, Sq, H, hd) in q's dtype, lse (B, H, Sq, 1) f32), as
    the forward kernel returns them."""
    B, Sq, H, hd = q.shape
    Skv, KVH = k.shape[1], k.shape[2]
    G = H // KVH
    scale = _scale(hd, sm_scale)

    qg = q.reshape(B, Sq, KVH, G, hd)
    s = torch.einsum("bqhgd,bkhd->bhgqk", qg.float(), k.float())
    s = s * scale
    s = s.masked_fill(~_mask(Sq, Skv, causal, window, q_offset, q.device), float("-inf"))

    p = torch.softmax(s, dim=-1)
    o = torch.einsum("bhgqk,bkhd->bqhgd", p, v.float())
    lse = torch.logsumexp(s, dim=-1).reshape(B, H, Sq, 1)
    return o.reshape(B, Sq, H, hd).to(q.dtype), lse


def attention_ref(q, k, v, *, causal=True, window=0, q_offset=0, sm_scale=None):
    """The attention output alone (q, k, v as in ``attention_fwd_ref``)."""
    o, _ = attention_fwd_ref(q, k, v, causal=causal, window=window, q_offset=q_offset,
                             sm_scale=sm_scale)
    return o


def attention_bwd_ref(
    q: torch.Tensor,          # (B, Sq, H, hd)
    k: torch.Tensor,          # (B, Skv, KVH, hd)
    v: torch.Tensor,          # (B, Skv, KVH, hd)
    o: torch.Tensor,          # (B, Sq, H, hd) forward output
    lse: torch.Tensor,        # (B, H, Sq, 1) f32 forward log-sum-exp
    do: torch.Tensor,         # (B, Sq, H, hd)
    *,
    causal: bool = True,
    window: int = 0,
    q_offset: int = 0,
    sm_scale: float | None = None,
):
    """(dq, dk, dv) in the inputs' dtypes, from the formula of
    ``kernel_bwd.py``: delta = sum(do * o), p = exp(s * scale - lse) masked
    to 0, dv = p^T do, ds = p (do v^T - delta) scale, dk = ds^T q,
    dq = ds k; dk and dv sum over the G query heads of each kv head."""
    B, Sq, H, hd = q.shape
    Skv, KVH = k.shape[1], k.shape[2]
    G = H // KVH
    scale = _scale(hd, sm_scale)

    qg = q.reshape(B, Sq, KVH, G, hd).float()
    dog = do.reshape(B, Sq, KVH, G, hd).float()
    kf, vf = k.float(), v.float()
    rows = lambda t: t.reshape(B, KVH, G, Sq, 1)                     # (B, H, Sq) rows
    delta = (do.float() * o.float()).sum(-1).transpose(1, 2)          # (B, H, Sq)

    s = torch.einsum("bqhgd,bkhd->bhgqk", qg, kf) * scale
    mask = _mask(Sq, Skv, causal, window, q_offset, q.device)
    p = torch.where(mask, torch.exp(s - rows(lse)), 0.0)
    dv = torch.einsum("bhgqk,bqhgd->bkhd", p, dog)
    dp = torch.einsum("bqhgd,bkhd->bhgqk", dog, vf)
    ds = p * (dp - rows(delta)) * scale
    dk = torch.einsum("bhgqk,bqhgd->bkhd", ds, qg)
    dq = torch.einsum("bhgqk,bkhd->bqhgd", ds, kf).reshape(B, Sq, H, hd)
    return dq.to(q.dtype), dk.to(k.dtype), dv.to(v.dtype)
