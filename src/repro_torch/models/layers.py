"""Shared layers of the models (port of ``repro.models.layers``):
f32-internal RMSNorm and LayerNorm (``norm`` picks by the params), split-half RoPE, the gated MLP
(SwiGLU, GeGLU) and the biased GELU MLP, the qkv projection (queries and
keys/values from separate inputs for cross-attention) with its optional
bias and qk-norm, the plain blockwise attention used by prefill, training,
the encoder and cross-attention (``masked``: every q chunk scans every kv chunk;
``triangular``: a causal q chunk scans only the kv chunks at or below its
diagonal; full or sliding-window), one-token attention against a dense
(ring-buffer) KV cache, and one-token attention against the shared paged
pool. Both caches may hold int8 codes with a per-(row, kv head) scale.

Tensors keep the reference's layouts: activations ``(B, S, d)``, heads
``(B, S, H, hd)``, dense caches ``(B, T, KVH, hd)``, pools
``(P, page_size, KVH, hd)``. Unlike the JAX code, the decode writes update
the cache or pool in place (one buffer for the life of a cache, no copy
per step).
"""
from __future__ import annotations

import functools
from typing import Dict, Optional, Tuple

import numpy as np
import torch
import torch.nn.functional as F

from repro_torch.config.base import ModelConfig
from repro_torch.models import common
from repro_torch.models.common import ParamSpec

NEG_INF = -1e30  # large-negative for masking in f32 accumulation
PAGE_SIZE = 16   # token positions per pool page; matches cache_len_for's x16


# ---------------------------------------------------------------------------
# Norms, RoPE, MLP
# ---------------------------------------------------------------------------

def rmsnorm_spec(dim: int, axis: str = "embed") -> Dict[str, ParamSpec]:
    return {"scale": ParamSpec((dim,), (axis,), init="ones")}


def layernorm_spec(dim: int, axis: str = "embed") -> Dict[str, ParamSpec]:
    return {
        "scale": ParamSpec((dim,), (axis,), init="ones"),
        "bias": ParamSpec((dim,), (axis,), init="zeros"),
    }


def rmsnorm(params: Dict, x: torch.Tensor, eps: float) -> torch.Tensor:
    """RMSNorm in f32, output cast back to the input dtype."""
    dtype = x.dtype
    x = x.float()
    var = x.square().mean(dim=-1, keepdim=True)
    y = x * torch.rsqrt(var + eps) * params["scale"].float()
    return y.to(dtype)


def layernorm(params: Dict, x: torch.Tensor, eps: float) -> torch.Tensor:
    """LayerNorm in f32 (mean, then the variance of the centred values),
    output cast back to the input dtype."""
    dtype = x.dtype
    x = x.float()
    mu = x.mean(dim=-1, keepdim=True)
    var = (x - mu).square().mean(dim=-1, keepdim=True)
    y = (x - mu) * torch.rsqrt(var + eps)
    y = y * params["scale"].float() + params["bias"].float()
    return y.to(dtype)


def norm(params: Dict, x: torch.Tensor, cfg: ModelConfig) -> torch.Tensor:
    """LayerNorm where the params have a ``bias`` (whisper), else RMSNorm."""
    if "bias" in params:
        return layernorm(params, x, cfg.norm_eps)
    return rmsnorm(params, x, cfg.norm_eps)


@functools.lru_cache(maxsize=None)
def _rope_freq(hd: int, theta: float, device: torch.device) -> torch.Tensor:
    """Inverse frequencies, computed in numpy float32 exactly as the
    reference does, uploaded once per device (a host-to-device copy per
    call would stall the host until the card is idle)."""
    freq = 1.0 / (theta ** (np.arange(0, hd, 2, dtype=np.float32) / hd))
    return torch.from_numpy(np.asarray(freq, np.float32)).to(device)


def rope(x: torch.Tensor, positions: torch.Tensor, theta: float) -> torch.Tensor:
    """Rotary embedding, split-half. x: (..., S, H, hd); positions: (..., S)."""
    dtype = x.dtype
    freq = _rope_freq(x.shape[-1], float(theta), x.device)
    angles = positions[..., None].float() * freq          # (..., S, hd/2)
    cos = torch.cos(angles)[..., None, :]                  # broadcast over heads
    sin = torch.sin(angles)[..., None, :]
    x1, x2 = x.float().chunk(2, dim=-1)
    y = torch.cat([x1 * cos - x2 * sin, x2 * cos + x1 * sin], dim=-1)
    return y.to(dtype)


def mlp_spec(cfg: ModelConfig) -> Dict[str, ParamSpec]:
    d, f = cfg.d_model, cfg.d_ff
    if cfg.gated_mlp:
        return {
            "wi_gate": ParamSpec((d, f), ("embed", "ffn")),
            "wi_up": ParamSpec((d, f), ("embed", "ffn")),
            "wo": ParamSpec((f, d), ("ffn", "embed")),
        }
    return {
        "wi": ParamSpec((d, f), ("embed", "ffn")),
        "bi": ParamSpec((f,), ("ffn",), init="zeros"),
        "wo": ParamSpec((f, d), ("ffn", "embed")),
        "bo": ParamSpec((d,), ("embed",), init="zeros"),
    }


def _act(x: torch.Tensor, kind: str) -> torch.Tensor:
    """silu, or gelu as ``jax.nn.gelu`` computes it by default: the tanh
    approximation, not the erf form."""
    if kind == "silu":
        return F.silu(x)
    if kind == "gelu":
        return F.gelu(x, approximate="tanh")
    raise NotImplementedError(f"repro_torch: activation {kind!r}")


def mlp(params: Dict, x: torch.Tensor, cfg: ModelConfig) -> torch.Tensor:
    """SwiGLU or GeGLU, wo(act(x wi_gate) * x wi_up); or, not gated (whisper),
    act(x wi + bi) wo + bo, each bias cast to the compute dtype."""
    ct = cfg.dtype
    if cfg.gated_mlp:
        g = common.dense(x, params["wi_gate"], ct)
        u = common.dense(x, params["wi_up"], ct)
        return common.dense(_act(g, cfg.mlp_activation) * u, params["wo"], ct)
    dt = common.torch_dtype(ct)
    h = _act(common.dense(x, params["wi"], ct) + params["bi"].to(dt), cfg.mlp_activation)
    return common.dense(h, params["wo"], ct) + params["bo"].to(dt)


# ---------------------------------------------------------------------------
# Attention
# ---------------------------------------------------------------------------

def attention_spec(cfg: ModelConfig, cross: bool = False) -> Dict[str, ParamSpec]:
    """Projections (and the QKV bias, qk-norm scales where the config has
    them); ``cross``: an encoder-decoder's cross-attention, never qk-normed."""
    d = cfg.d_model
    qd, kd = cfg.q_dim, cfg.kv_dim
    spec: Dict[str, ParamSpec] = {
        "wq": ParamSpec((d, qd), ("embed", "q_dim")),
        "wk": ParamSpec((d, kd), ("embed", "kv_dim")),
        "wv": ParamSpec((d, kd), ("embed", "kv_dim")),
        "wo": ParamSpec((qd, d), ("q_dim", "embed")),
    }
    if cfg.qkv_bias:
        spec["bq"] = ParamSpec((qd,), ("q_dim",), init="zeros")
        spec["bk"] = ParamSpec((kd,), ("kv_dim",), init="zeros")
        spec["bv"] = ParamSpec((kd,), ("kv_dim",), init="zeros")
    if cfg.qk_norm and not cross:
        spec["q_norm"] = ParamSpec((cfg.resolved_head_dim,), ("head_dim",), init="ones")
        spec["k_norm"] = ParamSpec((cfg.resolved_head_dim,), ("head_dim",), init="ones")
    return spec


def _project_qkv(
    params: Dict, xq: torch.Tensor, xkv: torch.Tensor, cfg: ModelConfig
) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """xq (B,S,d), xkv (B,T,d) -> q (B,S,H,hd), k/v (B,T,KVH,hd): the bias
    (cast to the projection's dtype) before the head split, then qk-norm.
    Self-attention passes the same tensor twice."""
    ct = cfg.dtype
    hd = cfg.resolved_head_dim
    q = common.dense(xq, params["wq"], ct)
    k = common.dense(xkv, params["wk"], ct)
    v = common.dense(xkv, params["wv"], ct)
    if "bq" in params:
        q = q + params["bq"].to(q.dtype)
        k = k + params["bk"].to(k.dtype)
        v = v + params["bv"].to(v.dtype)
    q = q.reshape(*q.shape[:-1], cfg.num_heads, hd)
    k = k.reshape(*k.shape[:-1], cfg.num_kv_heads, hd)
    v = v.reshape(*v.shape[:-1], cfg.num_kv_heads, hd)
    if "q_norm" in params:
        q = rmsnorm({"scale": params["q_norm"]}, q, cfg.norm_eps)
        k = rmsnorm({"scale": params["k_norm"]}, k, cfg.norm_eps)
    return q, k, v


def _scores(q: torch.Tensor, k: torch.Tensor, scale: float) -> torch.Tensor:
    """q (B,Sq,KVH,G,hd) x k (B,T,KVH,hd) -> (B,KVH,G,Sq,T) f32; products of
    bf16 inputs are exact in f32, as with ``preferred_element_type``."""
    return torch.einsum("bqhgd,bthd->bhgqt", q.float(), k.float()) * scale


def _sdpa(
    q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
    mask: Optional[torch.Tensor], scale: float,
) -> torch.Tensor:
    """Plain softmax attention of one (q-block x kv-block) pair.

    q: (B, Sq, KVH, G, hd)  k/v: (B, T, KVH, hd)  mask: (B, Sq, T) or None.
    ``p`` is cast to the input dtype before the PV product, as the
    reference does.
    """
    s = _scores(q, k, scale)
    if mask is not None:
        s = torch.where(mask[:, None, None, :, :], s, NEG_INF)
    p = torch.softmax(s, dim=-1).to(q.dtype)
    return torch.einsum("bhgqt,bthd->bqhgd", p, v)


def _online_block(carry, q, k, v, mask, scale):
    """One online-softmax accumulation step over a kv chunk.

    carry: acc (B,Sq,KVH,G,hd) f32, m (B,KVH,G,Sq) f32, l (B,KVH,G,Sq) f32.
    """
    acc, m, l = carry
    s = _scores(q, k, scale)
    if mask is not None:
        s = torch.where(mask[:, None, None, :, :], s, NEG_INF)
    m_new = torch.maximum(m, s.amax(dim=-1))
    p = torch.exp(s - m_new[..., None])
    corr = torch.exp(m - m_new)
    l_new = l * corr + p.sum(dim=-1)
    pv = torch.einsum("bhgqt,bthd->bqhgd", p.to(q.dtype), v).float()
    acc_new = acc * corr.movedim(-1, 1)[..., None] + pv
    return acc_new, m_new, l_new


def blockwise_attention(
    q: torch.Tensor,
    k: torch.Tensor,
    v: torch.Tensor,
    *,
    causal: bool,
    q_chunk: int = 512,
    kv_chunk: int = 1024,
    window: int = 0,
    impl: str = "masked",
    q_offset: int = 0,
    kv_valid: Optional[int] = None,
) -> torch.Tensor:
    """The reference's blockwise attention. ``impl="masked"``: every q
    chunk scans every kv chunk under the mask. ``impl="triangular"`` with
    ``causal``: q chunk i scans only kv chunks ``0 .. ceil(((i + 1) q_chunk
    + q_offset) / kv_chunk)`` (capped at the count), the reference's static
    unroll; the chunks it skips are wholly masked, so the result is the
    masked one. q: (B,Sq,H,hd); k/v: (B,T,KVH,hd). Returns (B,Sq,H,hd).
    ``kv_valid``: kv rows at or past it are padding. With a sliding
    ``window`` (either ``impl``), each q chunk attends to a static band of
    ``window + q_chunk`` kv rows instead (one fused block per chunk).
    """
    B, Sq, H, hd = q.shape
    T, KVH = k.shape[1], k.shape[2]
    G = H // KVH
    scale = float(1.0 / np.sqrt(hd))
    qg = q.reshape(B, Sq, KVH, G, hd)
    dev = q.device

    q_chunk = min(q_chunk, Sq)
    kv_chunk = min(kv_chunk, T)
    if Sq <= q_chunk and T <= kv_chunk:
        q_pos = q_offset + torch.arange(Sq, device=dev)
        kv_pos = torch.arange(T, device=dev)
        mask = torch.ones((Sq, T), dtype=torch.bool, device=dev)
        if causal:
            mask &= q_pos[:, None] >= kv_pos[None, :]
        if window:
            mask &= q_pos[:, None] - kv_pos[None, :] < window
        if kv_valid is not None and kv_valid < T:
            mask &= (kv_pos < kv_valid)[None, :]
        out = _sdpa(qg, k, v, mask.expand(B, Sq, T), scale)
        return out.reshape(B, Sq, H, hd)

    # ragged lengths: pad to the chunk grid, mask padded kv rows, drop padded q rows
    pad_q = (-Sq) % q_chunk
    pad_kv = (-T) % kv_chunk if window == 0 else 0
    if pad_q or pad_kv:
        q_p = F.pad(q, (0, 0, 0, 0, 0, pad_q))
        k_p = F.pad(k, (0, 0, 0, 0, 0, pad_kv))
        v_p = F.pad(v, (0, 0, 0, 0, 0, pad_kv))
        out = blockwise_attention(
            q_p, k_p, v_p, causal=causal, window=window, q_chunk=q_chunk, kv_chunk=kv_chunk,
            impl=impl, q_offset=q_offset, kv_valid=T,
        )
        return out[:, :Sq]

    if window:
        # per q chunk, the static band of kv rows that can reach it
        band = min(window + q_chunk, T)
        outs = []
        for i in range(Sq // q_chunk):
            qs = q_offset + i * q_chunk
            start = min(max(qs + q_chunk - band, 0), T - band)
            q_pos = qs + torch.arange(q_chunk, device=dev)
            kv_pos = start + torch.arange(band, device=dev)
            mask = q_pos[:, None] - kv_pos[None, :] < window
            if causal:
                mask &= q_pos[:, None] >= kv_pos[None, :]
            if kv_valid is not None and kv_valid < T:
                mask &= (kv_pos < kv_valid)[None, :]
            outs.append(_sdpa(qg[:, i * q_chunk:(i + 1) * q_chunk], k[:, start:start + band],
                              v[:, start:start + band], mask.expand(B, q_chunk, band), scale))
        return torch.cat(outs, dim=1).reshape(B, Sq, H, hd)

    n_kv = T // kv_chunk
    outs = []
    for i in range(Sq // q_chunk):
        qc = qg[:, i * q_chunk:(i + 1) * q_chunk]
        q_pos = q_offset + i * q_chunk + torch.arange(q_chunk, device=dev)
        acc = torch.zeros((B, q_chunk, KVH, G, hd), dtype=torch.float32, device=dev)
        m = torch.full((B, KVH, G, q_chunk), NEG_INF, dtype=torch.float32, device=dev)
        l = torch.zeros((B, KVH, G, q_chunk), dtype=torch.float32, device=dev)
        n_vis = n_kv
        if impl == "triangular" and causal:
            n_vis = min(-(-((i + 1) * q_chunk + q_offset) // kv_chunk), n_kv)
        for j in range(n_vis):
            kv_pos = j * kv_chunk + torch.arange(kv_chunk, device=dev)
            mask = None
            if causal:
                mask = q_pos[:, None] >= kv_pos[None, :]
            if kv_valid is not None and kv_valid < T:
                bound = (kv_pos < kv_valid)[None, :]
                mask = bound if mask is None else mask & bound
            if mask is not None:
                mask = mask.expand(B, q_chunk, kv_chunk)
            sl = slice(j * kv_chunk, (j + 1) * kv_chunk)
            acc, m, l = _online_block((acc, m, l), qc, k[:, sl], v[:, sl], mask, scale)
        out = acc / torch.clamp(l.movedim(-1, 1)[..., None], min=1e-37)
        outs.append(out.to(q.dtype))
    return torch.cat(outs, dim=1).reshape(B, Sq, H, hd)


def cross_attention_layer(
    params: Dict, x: torch.Tensor, memory: torch.Tensor, cfg: ModelConfig,
) -> torch.Tensor:
    """Encoder-decoder cross-attention (no RoPE, no mask) of x (B,S,d) over
    the encoder's memory (B,T,d), through the plain blockwise attention at
    the reference's fixed 512 / 512 chunks (a memory of 1500 frames is
    padded to 1536, the pad rows masked). Returns (B,S,d) projected by
    ``wo``."""
    q, k, v = _project_qkv(params, x, memory, cfg)
    out = blockwise_attention(q, k, v, causal=False, q_chunk=512, kv_chunk=512)
    B, S = x.shape[:2]
    return common.dense(out.reshape(B, S, cfg.q_dim), params["wo"], cfg.dtype)


# ---------------------------------------------------------------------------
# Dense KV cache (lock-step decode)
# ---------------------------------------------------------------------------

def make_cache_specs(
    cfg: ModelConfig, batch: int, cache_len: int, int8: bool = False,
) -> Dict[str, ParamSpec]:
    """Dense KV-cache entry for ONE layer (stacked over layers by the
    caller). ``pos_ids`` holds the absolute position in each slot (-1 =
    empty), which serves full caches and ring-buffer window caches alike.
    ``int8``: k and v hold int8 codes, and ``k_scale`` / ``v_scale`` (in
    ``cfg.dtype``) one scale per (batch, slot, kv head)."""
    hd = cfg.resolved_head_dim
    shape = (batch, cache_len, cfg.num_kv_heads, hd)
    axes = ("batch", "seq", "kv_heads", "head_dim")
    kv_dtype = "int8" if int8 else cfg.dtype
    spec = {
        "k": ParamSpec(shape, axes, init="zeros", dtype=kv_dtype),
        "v": ParamSpec(shape, axes, init="zeros", dtype=kv_dtype),
        "pos_ids": ParamSpec((cache_len,), (None,), init="zeros", dtype="int32"),
    }
    if int8:
        s_shape, s_axes = shape[:-1] + (1,), axes[:-1] + (None,)
        spec["k_scale"] = ParamSpec(s_shape, s_axes, init="zeros", dtype=cfg.dtype)
        spec["v_scale"] = ParamSpec(s_shape, s_axes, init="zeros", dtype=cfg.dtype)
    return spec


def _quantize_kv(x: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """Symmetric int8 quantization over the last (head) dim: (codes int8,
    f32 scale with a trailing dim of 1). ``torch.round`` rounds half to
    even, as ``jnp.round`` does."""
    xf = x.float()
    scale = torch.clamp(xf.abs().amax(dim=-1, keepdim=True) / 127.0, min=1e-8)
    q = torch.clamp(torch.round(xf / scale), -127, 127).to(torch.int8)
    return q, scale


def _dequantize_kv(q: torch.Tensor, scale: torch.Tensor, dtype) -> torch.Tensor:
    return (q.float() * scale.float()).to(dtype)


def decode_attention(
    params: Dict,
    cache: Dict,
    x: torch.Tensor,
    pos: int,
    cfg: ModelConfig,
) -> Tuple[torch.Tensor, Dict]:
    """One-token attention against a (possibly ring-buffer) dense KV cache.

    x: (B, 1, d); pos: the absolute position of this token. The token's
    k/v and position go into slot ``pos % T`` of ``cache`` IN PLACE (the
    reference returns an updated copy); a slot is attended to when it holds
    a position at or before ``pos`` and, with a window, less than
    ``cfg.window`` behind it. Returns (output projected by ``wo`` (B, 1, d),
    cache).
    """
    B = x.shape[0]
    hd = cfg.resolved_head_dim
    q, k_new, v_new = _project_qkv(params, x, x, cfg)
    positions = torch.full((B, 1), float(pos), device=x.device)
    q = rope(q, positions, cfg.rope_theta)
    k_new = rope(k_new, positions, cfg.rope_theta)

    k, v, pos_ids = cache["k"], cache["v"], cache["pos_ids"]
    T = k.shape[1]
    slot = pos % T
    if k.dtype == torch.int8:
        # quantize the new row, write codes and (cfg.dtype) scales, then
        # attend over the whole ring dequantized with the stored scales
        for key, new in (("k", k_new), ("v", v_new)):
            codes, scale = _quantize_kv(new[:, 0])
            cache[key][:, slot] = codes
            cache[key + "_scale"][:, slot] = scale.to(cache[key + "_scale"].dtype)
        k_use = _dequantize_kv(k, cache["k_scale"], q.dtype)
        v_use = _dequantize_kv(v, cache["v_scale"], q.dtype)
    else:
        k[:, slot] = k_new[:, 0].to(k.dtype)
        v[:, slot] = v_new[:, 0].to(v.dtype)
        k_use, v_use = k.to(q.dtype), v.to(q.dtype)
    pos_ids[slot] = pos

    valid = pos_ids >= 0
    if cfg.window:
        valid &= pos - pos_ids < cfg.window
    valid &= pos_ids <= pos

    KVH = cfg.num_kv_heads
    qg = q.reshape(B, 1, KVH, cfg.num_heads // KVH, hd)
    mask = valid[None, None, :].expand(B, 1, T)
    out = _sdpa(qg, k_use, v_use, mask, float(1.0 / np.sqrt(hd)))
    out = out.reshape(B, 1, cfg.num_heads * hd)
    return common.dense(out, params["wo"], cfg.dtype), cache


# ---------------------------------------------------------------------------
# Paged KV cache (serving decode)
# ---------------------------------------------------------------------------

def make_paged_cache_specs(
    cfg: ModelConfig, num_pages: int, page_size: int = PAGE_SIZE, int8: bool = False,
) -> Dict[str, ParamSpec]:
    """Paged-KV pool entry for ONE layer (stacked by the caller).

    ``num_pages`` blocks of ``page_size`` consecutive token positions,
    shared by every sequence through per-lane block tables. The LAST page
    is the trash page: dead decode lanes write there and it is never
    allocated or attended to. ``int8``: int8 codes, and ``k_scale`` /
    ``v_scale`` (in ``cfg.dtype``) one scale per (page row, kv head).
    """
    hd = cfg.resolved_head_dim
    shape = (num_pages, page_size, cfg.num_kv_heads, hd)
    axes = (None, None, "kv_heads", "head_dim")
    kv_dtype = "int8" if int8 else cfg.dtype
    spec = {
        "k_pages": ParamSpec(shape, axes, init="zeros", dtype=kv_dtype),
        "v_pages": ParamSpec(shape, axes, init="zeros", dtype=kv_dtype),
    }
    if int8:
        s_shape, s_axes = shape[:-1] + (1,), axes[:-1] + (None,)
        spec["k_scale"] = ParamSpec(s_shape, s_axes, init="zeros", dtype=cfg.dtype)
        spec["v_scale"] = ParamSpec(s_shape, s_axes, init="zeros", dtype=cfg.dtype)
    return spec


def _paged_write(pages: torch.Tensor, new: torch.Tensor, rows: torch.Tensor) -> None:
    """Scatter one token per sequence into the flattened pool, in place.

    pages: (P, ps, ...); new: (B, ...); rows: (B,) flattened pool rows.
    Live rows are unique by construction; only trash-page rows may
    collide, and those are never read back.
    """
    P, ps = pages.shape[:2]
    flat = pages.view(P * ps, *pages.shape[2:])
    flat[rows.long()] = new.to(pages.dtype)


def decode_attention_paged(
    params: Dict,
    cache: Dict,
    x: torch.Tensor,
    seq_lens: torch.Tensor,     # (B,) int32: tokens already cached per lane
    block_table: torch.Tensor,  # (B, max_blocks) int32; -1 = unassigned
    cfg: ModelConfig,
) -> torch.Tensor:
    """One-token attention against the shared paged pool; writes this
    token's k/v into ``cache`` in place and returns the attention output
    projected by ``wo``, (B, 1, d).

    ``seq_lens[b]`` is both the number of cached tokens and the absolute
    position of lane b's token. A dead lane (unassigned page at its write
    index) writes to the trash page and attends over zero positions.
    A bf16 or f32 pool attends through ``paged_decode_attention``: the CUDA
    kernel on a GPU tensor, the plain ``paged_attention_ref`` on the CPU.
    An int8 pool has its codes and scales written through ``_paged_write``,
    then attends through ``paged_decode_attention_int8``: on a GPU tensor the
    int8 variant of the CUDA kernel, which dequantizes each tile as it
    stages it; on the CPU the plain ``paged_attention_int8_ref``, the
    reference's gather path (the block table's pages, ``max(table, 0)``,
    gathered and only those dequantized, then masked attention over the
    gathered rows, as its ``_paged_attend_gathered``).
    """
    from repro_torch.kernels.paged_attention import (paged_decode_attention,
                                                     paged_decode_attention_int8)

    B = x.shape[0]
    hd = cfg.resolved_head_dim
    k_pages, v_pages = cache["k_pages"], cache["v_pages"]
    P, ps = k_pages.shape[:2]

    pos = seq_lens.to(torch.int32)
    q, k_new, v_new = _project_qkv(params, x, x, cfg)
    q = rope(q, pos[:, None].float(), cfg.rope_theta)
    k_new = rope(k_new, pos[:, None].float(), cfg.rope_theta)

    pidx = torch.clamp(pos // ps, 0, block_table.shape[1] - 1)
    page = torch.gather(block_table, 1, pidx[:, None].long())[:, 0]
    live = page >= 0
    dest = torch.where(live, page, P - 1)  # trash page for dead lanes
    rows = dest * ps + pos % ps
    lens_att = torch.where(live, pos + 1, 0).to(torch.int32)
    if k_pages.dtype == torch.int8:
        for key, new in (("k", k_new), ("v", v_new)):
            codes, scale = _quantize_kv(new[:, 0])
            _paged_write(cache[key + "_pages"], codes, rows)
            _paged_write(cache[key + "_scale"], scale, rows)
        out = paged_decode_attention_int8(q[:, 0], k_pages, v_pages, cache["k_scale"],
                                          cache["v_scale"], block_table, lens_att)
    else:
        _paged_write(k_pages, k_new[:, 0], rows)
        _paged_write(v_pages, v_new[:, 0], rows)
        out = paged_decode_attention(q[:, 0], k_pages, v_pages, block_table, lens_att)
    out = out.reshape(B, 1, cfg.num_heads * hd)
    return common.dense(out, params["wo"], cfg.dtype)

