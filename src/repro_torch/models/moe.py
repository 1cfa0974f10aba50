"""Mixture-of-Experts block (port of ``repro.models.moe``): top-k routing
with capacity-bounded scatter dispatch.

Tokens are dispatched within *groups* (one group per sequence when S > 1,
one global group when S == 1), each assignment takes the next slot of its
expert's buffer in the order ``t0k0, t0k1, t1k0, ...``, and an assignment
whose slot is past the capacity is dropped (the residual keeps the token).
The expert FFN is a batched product over the expert dim.

Where the port must take care to stay the reference's function:

* the router runs in f32 from f32 weights (``keep_f32``: serving stores
  the other matrices in bf16, and a router rounded to bf16 would flip
  top-k picks);
* top-k ties resolve to the lower expert index, as ``jax.lax.top_k``
  does: a stable descending sort;
* the scatter writes each kept assignment's row into its own slot and each
  dropped one into a trash row of its own, so no two writes meet (no
  atomics, the same bits every run); every dropped assignment then reads
  the zero row, as the reference's drop slot ``E*cap`` gives;
* ``_capacity`` is Python's ``int()`` of a float, and the decode step's
  forward-equivalent capacity is computed in f32 from ``pos + 1``.
"""
from __future__ import annotations

from typing import Dict, Tuple

import numpy as np
import torch
import torch.nn.functional as F

from repro_torch.config.base import ModelConfig
from repro_torch.models import common
from repro_torch.models.common import ParamSpec


def moe_spec(cfg: ModelConfig) -> Dict[str, ParamSpec]:
    assert cfg.moe is not None
    if not cfg.gated_mlp or cfg.mlp_activation != "silu":
        raise NotImplementedError("repro_torch: only gated (SwiGLU) experts are ported")
    d, f, e = cfg.d_model, cfg.d_ff, cfg.moe.num_experts
    return {
        # the router is read in f32 (routing decides which experts run)
        "router": ParamSpec((d, e), ("embed", "experts"), keep_f32=True),
        "wi_gate": ParamSpec((e, d, f), ("experts", "embed", "ffn")),
        "wi_up": ParamSpec((e, d, f), ("experts", "embed", "ffn")),
        "wo": ParamSpec((e, f, d), ("experts", "ffn", "embed")),
    }


def _capacity(cfg: ModelConfig, group_tokens: int) -> int:
    m = cfg.moe
    c = int(m.top_k * m.capacity_factor * group_tokens / m.num_experts)
    return max(c, 1)


def _top_k(probs: torch.Tensor, k: int) -> Tuple[torch.Tensor, torch.Tensor]:
    """``jax.lax.top_k``: the k largest, descending, ties to the lower index."""
    vals, idx = torch.sort(probs, dim=-1, descending=True, stable=True)
    return vals[..., :k], idx[..., :k]


def _route(params, x: torch.Tensor, cfg: ModelConfig):
    """(probs, top_w normalized, top_i) of x (..., d), all routing in f32."""
    logits = common.dense(x, params["router"], "float32")
    probs = torch.softmax(logits.float(), dim=-1)
    top_w, top_i = _top_k(probs, cfg.moe.top_k)
    top_w = top_w / torch.clamp(top_w.sum(-1, keepdim=True), min=1e-9)
    return probs, top_w, top_i


def _dispatch_experts(params, xk, a, onehot, keep, cap: int, cfg: ModelConfig):
    """Scatter assignments into capacity-``cap`` per-expert buffers, run the
    expert FFN, gather back.

    xk: (G, A, d) one row per assignment; a: (G, A) expert ids (int64);
    onehot: (G, A, E) int32 of ``a``; keep: (G, A) bool pre-drop decision.
    Dropped assignments take no buffer slot. Returns (picked (G, A, d)
    expert outputs, zero where dropped; keep after buffer-overflow drops).
    """
    G, A, d = xk.shape
    E = cfg.moe.num_experts
    ct = common.torch_dtype(cfg.dtype)
    pos = torch.gather(torch.cumsum(onehot * keep[..., None], dim=1) - 1, 2,
                       a[..., None])[..., 0]                       # (G, A)
    keep = keep & (pos < cap)
    slots = E * cap
    base = torch.arange(G, device=xk.device)[:, None] * slots
    slot = base + a * cap + pos                                    # kept: its expert slot
    trash = G * slots + torch.arange(G * A, device=xk.device).reshape(G, A)
    rows = xk.to(ct).reshape(G * A, d)
    buf = torch.zeros((G * slots + G * A, d), dtype=ct, device=xk.device).index_copy(
        0, torch.where(keep, slot, trash).reshape(-1), rows)
    expert_in = buf[:G * slots].reshape(G, E, cap, d)

    # the expert FFN (SwiGLU), batched over the expert dim
    g = torch.einsum("gecd,edf->gecf", expert_in, params["wi_gate"].to(ct))
    u = torch.einsum("gecd,edf->gecf", expert_in, params["wi_up"].to(ct))
    h = F.silu(g) * u
    expert_out = torch.einsum("gecf,efd->gecd", h, params["wo"].to(ct))

    flat = torch.cat([expert_out.reshape(G * slots, d), expert_out.new_zeros((1, d))])
    picked = flat[torch.where(keep, slot, G * slots)]              # (G, A, d)
    return picked, keep


def moe_load_spec(cfg: ModelConfig, batch: int) -> ParamSpec:
    """Per-sequence expert assignment counters carried in the decode cache:
    ``load[b, e]`` counts the assignments sequence ``b`` has routed to
    expert ``e`` so far, kept and capacity-dropped."""
    assert cfg.moe is not None
    return ParamSpec(
        (batch, cfg.moe.num_experts), ("batch", None), init="zeros", dtype="int32"
    )


def moe_block(
    params: Dict, x: torch.Tensor, cfg: ModelConfig
) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """x: (B, S, d) -> (out (B, S, d), aux_loss f32 scalar, load (B, E) int32)."""
    m = cfg.moe
    B, S, d = x.shape
    E, K = m.num_experts, m.top_k
    ct = common.torch_dtype(cfg.dtype)

    # grouping: per sequence for train/prefill, one global group for S == 1
    if S > 1:
        G, N = B, S
        xg = x
    else:
        G, N = 1, B
        xg = x.reshape(1, B, d)
    C = _capacity(cfg, N)

    probs, top_w, top_i = _route(params, xg, cfg)                 # (G, N, E), (G, N, K)

    # load-balancing auxiliary loss (Switch-style)
    density = F.one_hot(top_i[..., 0], E).float().mean(dim=(0, 1))
    mean_prob = probs.mean(dim=(0, 1))
    aux = m.aux_loss_weight * E * torch.sum(density * mean_prob)

    # one row per assignment, token t's K picks contiguous: (t0k0, t0k1, t1k0, ...)
    a = top_i.reshape(G, N * K)
    onehot = F.one_hot(a, E).to(torch.int32)                       # (G, N*K, E)
    xk = xg[:, :, None, :].expand(G, N, K, d).reshape(G, N * K, d)

    if S > 1:
        load = onehot.sum(dim=1, dtype=torch.int32)                # groups are sequences
    else:
        load = onehot.reshape(B, K, E).sum(dim=1, dtype=torch.int32)

    picked, keep = _dispatch_experts(params, xk, a, onehot, torch.ones_like(a, dtype=torch.bool),
                                     C, cfg)
    w = (top_w.reshape(G, N * K) * keep).to(ct)
    out = torch.sum(picked.reshape(G, N, K, d) * w.reshape(G, N, K, 1), dim=2)
    return out.reshape(B, S, d), aux, load


def moe_decode_block(
    params: Dict,
    x: torch.Tensor,
    load: torch.Tensor,
    pos: int,
    cfg: ModelConfig,
    packing: str = "sequence",
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Single-token MoE step with forward-consistent capacity routing.

    x: (B, 1, d); load: (B, E) int32 counters (:func:`moe_load_spec`); pos:
    the absolute position of the token. Returns (out (B, 1, d), new load).
    An assignment is kept when its counter is below the capacity
    C(pos + 1) that a full forward over pos + 1 tokens would give, so decode
    keeps and drops what the teacher-forced forward does. ``packing``:
    ``"sequence"`` (one group per sequence, one slot per (sequence,
    expert): the counters alone decide) or ``"global"`` (one group over the
    batch with ``c_pack = ceil(K * cf * B / E)`` slots an expert; its
    overflow is dropped).
    """
    m = cfg.moe
    B, S, d = x.shape
    assert S == 1, "moe_decode_block handles one token per step"
    E, K = m.num_experts, m.top_k
    ct = common.torch_dtype(cfg.dtype)

    _, top_w, top_i = _route(params, x[:, 0], cfg)                 # (B, K)

    # forward-equivalent capacity for a sequence of length pos + 1, in f32
    c_seq = int(max(np.floor(np.float32(K * m.capacity_factor) * np.float32(int(pos) + 1)
                             / np.float32(E)), np.float32(1.0)))
    prior = torch.gather(load, 1, top_i)                           # (B, K)
    keep = prior < c_seq
    onehot_seq = F.one_hot(top_i, E).to(torch.int32)               # (B, K, E)
    new_load = load + onehot_seq.sum(dim=1).to(load.dtype)

    if packing == "sequence":
        xk = x.reshape(B, 1, d).expand(B, K, d)
        picked, keep_flat = _dispatch_experts(params, xk, top_i, onehot_seq, keep, 1, cfg)
        w = (top_w * keep_flat).to(ct)
        out = torch.sum(picked * w[..., None], dim=1)
    elif packing == "global":
        c_pack = max(int(np.ceil(K * m.capacity_factor * B / E)), 1)
        a = top_i.reshape(1, B * K)
        onehot = F.one_hot(a, E).to(torch.int32)
        xk = x.reshape(B, 1, d).expand(B, K, d).reshape(1, B * K, d)
        picked, keep_flat = _dispatch_experts(params, xk, a, onehot, keep.reshape(1, B * K),
                                              c_pack, cfg)
        w = (top_w.reshape(1, B * K) * keep_flat).to(ct)
        out = torch.sum(picked.reshape(B, K, d) * w.reshape(B, K, 1), dim=1)
    else:
        raise ValueError(f"unknown packing {packing!r}")
    return out.reshape(B, 1, d), new_load
