"""The dense decoder's drivers (port of ``repro.models.transformer``):
``forward_hidden`` / ``forward_train`` (full-sequence training forward,
each layer under ``torch.utils.checkpoint`` when ``remat="full"``),
``prefill`` (full-sequence forward that builds the dense KV cache) and
``decode_step_paged`` (one continuous-batching token per lane against the
paged pool). The layer loop is a Python loop over per-layer views of the
stacked parameters.

Only DENSE blocks with full attention are ported in this slice; the other
families raise ``NotImplementedError``.
"""
from __future__ import annotations

import dataclasses
from typing import Any, Callable, Dict

import torch
import torch.utils.checkpoint

from repro_torch.config.base import AttentionKind, BlockKind, ModelConfig
from repro_torch.models import common, layers
from repro_torch.models.common import ParamSpec


@dataclasses.dataclass(frozen=True)
class RunOpts:
    """Execution knobs from ``ShardingLayout`` that change how attention
    runs, not what it computes."""

    attn_impl: str = "masked"      # masked | flash
    q_chunk: int = 512
    kv_chunk: int = 1024
    remat: str = "full"            # none | full ("dots" is not ported)
    int8_kv_cache: bool = False


def _check_supported(cfg: ModelConfig, opts: RunOpts | None = None) -> None:
    if cfg.block != BlockKind.DENSE or cfg.attention != AttentionKind.FULL:
        raise NotImplementedError(
            f"repro_torch serves DENSE full-attention models only, got "
            f"{cfg.block.value}/{cfg.attention.value}"
        )
    if cfg.tie_embeddings or cfg.embed_scale or cfg.vision_tokens or cfg.encoder_layers:
        raise NotImplementedError(f"repro_torch: {cfg.name} needs a later slice")
    if opts is not None:
        if opts.int8_kv_cache:
            raise NotImplementedError("repro_torch: the int8 KV cache is not ported yet")
        if opts.attn_impl not in ("masked", "flash"):
            raise NotImplementedError(f"repro_torch: attn_impl {opts.attn_impl!r}")
        if opts.remat not in ("none", "full"):
            raise NotImplementedError(f"repro_torch: remat {opts.remat!r} is not ported yet")


# ---------------------------------------------------------------------------
# Specs
# ---------------------------------------------------------------------------

def block_spec(cfg: ModelConfig) -> Dict[str, Any]:
    return {
        "ln1": layers.rmsnorm_spec(cfg.d_model),
        "attn": layers.attention_spec(cfg),
        "ln2": layers.rmsnorm_spec(cfg.d_model),
        "mlp": layers.mlp_spec(cfg),
    }


def model_specs(cfg: ModelConfig) -> Dict[str, Any]:
    _check_supported(cfg)
    d = cfg.d_model
    return {
        "embed": ParamSpec((cfg.vocab_size, d), ("vocab", "embed"), init="embed"),
        "final_norm": layers.rmsnorm_spec(d),
        "lm_head": ParamSpec((d, cfg.vocab_size), ("embed", "vocab")),
        "blocks": common.stacked(block_spec(cfg), cfg.num_layers),
    }


def cache_len_for(cfg: ModelConfig, seq_len: int) -> int:
    """Dense cache length: the sequence rounded up to a multiple of 16
    (full attention only; ring-buffer window caches come with SWA)."""
    return -(-seq_len // 16) * 16


def paged_cache_specs(
    cfg: ModelConfig, num_pages: int, page_size: int = layers.PAGE_SIZE,
) -> Dict[str, Any]:
    """Paged KV pool specs, stacked over layers (serving decode engine)."""
    _check_supported(cfg)
    one = layers.make_paged_cache_specs(cfg, num_pages, page_size)
    return {"blocks": common.stacked(one, cfg.num_layers)}


def init_paged_cache(
    cfg: ModelConfig, num_pages: int, device, page_size: int = layers.PAGE_SIZE,
) -> Dict[str, Any]:
    specs = paged_cache_specs(cfg, num_pages, page_size)
    return common.tree_map(
        lambda s: torch.zeros(s.shape, dtype=common.torch_dtype(s.dtype), device=device),
        specs,
    )


def layer_slice(tree: Dict[str, Any], i: int) -> Dict[str, Any]:
    """Layer ``i`` of a stacked tree: views, so in-place writes land in it."""
    return common.tree_map(lambda t: t[i], tree)


def per_layer(params: Dict[str, Any], n: int, fn: Callable = lambda t: t) -> Dict[str, Any]:
    """``params`` with ``fn`` applied to each top-level leaf and to each
    layer slice of the stacked ``blocks``, which become a list of n trees.

    The train step differentiates ``per_layer(params, n, lambda t:
    t.detach().requires_grad_())``: leaves that share the stacked storage,
    each with its own ``.grad``. Differentiating through ``layer_slice`` of
    a stacked leaf instead would add a zero-filled gradient of the WHOLE
    leaf for every layer.
    """
    out = {k: common.tree_map(fn, v) for k, v in params.items() if k != "blocks"}
    out["blocks"] = [common.tree_map(fn, layer_slice(params["blocks"], i)) for i in range(n)]
    return out


# ---------------------------------------------------------------------------
# Blocks
# ---------------------------------------------------------------------------

def _attn_full(params, h, positions, cfg: ModelConfig, opts: RunOpts):
    """Self-attention returning the output and the roped (k, v) to cache."""
    q, k, v = layers._project_qkv(params, h, cfg)
    q = layers.rope(q, positions, cfg.rope_theta)
    k = layers.rope(k, positions, cfg.rope_theta)
    if opts.attn_impl == "flash":
        # the CUDA flash kernel on a GPU tensor, its plain version on the CPU
        from repro_torch.kernels.flash_attention import flash_attention

        out = flash_attention(q, k, v, True, 0, 0)
    else:
        out = layers.blockwise_attention(
            q, k, v, causal=True, q_chunk=opts.q_chunk, kv_chunk=opts.kv_chunk,
        )
    B, S = h.shape[:2]
    out = out.reshape(B, S, cfg.q_dim)
    return common.dense(out, params["wo"], cfg.dtype), (k, v)


def _kv_to_cache(kv, positions, cache_len: int) -> Dict[str, torch.Tensor]:
    """Write the last ``cache_len`` positions of (k, v) into a fresh cache."""
    k, v = kv
    S = k.shape[1]
    T = cache_len
    if S >= T:
        kc, vc = k[:, S - T:], v[:, S - T:]
        pos_ids = positions[0, S - T:].to(torch.int32)
        order = torch.argsort(pos_ids % T, stable=True)   # ring layout: slot = pos % T
        return {"k": kc[:, order], "v": vc[:, order], "pos_ids": pos_ids[order]}
    pad = T - S
    pad_kv = (0, 0, 0, 0, 0, pad)
    pos_ids = torch.cat([
        positions[0].to(torch.int32),
        torch.full((pad,), -1, dtype=torch.int32, device=k.device),
    ])
    return {"k": torch.nn.functional.pad(k, pad_kv),
            "v": torch.nn.functional.pad(v, pad_kv), "pos_ids": pos_ids}


def _embed_tokens(params, tokens: torch.Tensor, cfg: ModelConfig) -> torch.Tensor:
    return params["embed"][tokens.long()].to(common.torch_dtype(cfg.dtype))


def _embed_inputs(params, batch, cfg: ModelConfig):
    """tokens (text only) -> (x, positions)."""
    x = _embed_tokens(params, batch["tokens"], cfg)
    B, S = x.shape[:2]
    positions = torch.arange(S, dtype=torch.int32, device=x.device).expand(B, S)
    return x, positions


def _unembed(params, x: torch.Tensor, cfg: ModelConfig) -> torch.Tensor:
    x = layers.rmsnorm(params["final_norm"], x, cfg.norm_eps)
    return common.dense(x, params["lm_head"], cfg.dtype)


def _maybe_remat(fn, opts: RunOpts):
    """``remat="full"``: keep only each call's inputs and recompute the
    rest in backward (``jax.checkpoint``'s counterpart)."""
    if opts.remat == "none":
        return fn
    return lambda *args: torch.utils.checkpoint.checkpoint(fn, *args, use_reentrant=False)


# ---------------------------------------------------------------------------
# Drivers
# ---------------------------------------------------------------------------

def forward_hidden(params, batch, cfg: ModelConfig, opts: RunOpts):
    """Full-sequence forward up to (but excluding) the LM head.

    Returns (normed hidden states (B, S, d), aux_loss) — the fused
    cross-entropy in ``train/steps.py`` consumes this and never materializes
    the full (B, S, vocab) logits. ``params["blocks"]`` is the stacked tree
    or, to differentiate, a list of per-layer trees (see ``per_layer``).
    """
    _check_supported(cfg, opts)
    blocks = params["blocks"]
    if not isinstance(blocks, list):
        blocks = [layer_slice(blocks, i) for i in range(cfg.num_layers)]
    x, positions = _embed_inputs(params, batch, cfg)

    def body(xx, p):
        h = layers.rmsnorm(p["ln1"], xx, cfg.norm_eps)
        attn_out, _ = _attn_full(p["attn"], h, positions, cfg, opts)
        xx = xx + attn_out
        h = layers.rmsnorm(p["ln2"], xx, cfg.norm_eps)
        return xx + layers.mlp(p["mlp"], h, cfg)

    body = _maybe_remat(body, opts)
    for p in blocks:
        x = body(x, p)
    x = layers.rmsnorm(params["final_norm"], x, cfg.norm_eps)
    return x, torch.zeros((), dtype=torch.float32, device=x.device)


def unembed_weight(params, cfg: ModelConfig) -> torch.Tensor:
    """(d, vocab) projection (tied embeddings come with a later slice)."""
    return params["lm_head"]


def forward_train(params, batch, cfg: ModelConfig, opts: RunOpts):
    """Full-sequence forward. Returns (logits (B, S, V), aux_loss)."""
    x, aux = forward_hidden(params, batch, cfg, opts)
    return common.dense(x, unembed_weight(params, cfg), cfg.dtype), aux


def prefill(params, batch, cfg: ModelConfig, opts: RunOpts, cache_seq_len: int):
    """Forward + dense cache build. ``batch["tokens"]``: (B, S) int.
    Returns (last-position logits (B, 1, V), cache)."""
    _check_supported(cfg, opts)
    x, positions = _embed_inputs(params, batch, cfg)
    T = cache_len_for(cfg, cache_seq_len)
    caches = []
    for i in range(cfg.num_layers):
        p = layer_slice(params["blocks"], i)
        h = layers.rmsnorm(p["ln1"], x, cfg.norm_eps)
        attn_out, kv = _attn_full(p["attn"], h, positions, cfg, opts)
        x = x + attn_out
        h = layers.rmsnorm(p["ln2"], x, cfg.norm_eps)
        x = x + layers.mlp(p["mlp"], h, cfg)
        caches.append(_kv_to_cache(kv, positions, T))
    cache = {"blocks": {key: torch.stack([c[key] for c in caches]) for key in caches[0]}}
    return _unembed(params, x[:, -1:, :], cfg), cache


def decode_step_paged(
    params, cache, tokens, seq_lens, block_table, cfg: ModelConfig, opts: RunOpts,
):
    """One continuous-batching decode step against the paged KV pool.

    tokens: (B, 1) int; seq_lens: (B,) int32 per-lane cached-token counts
    (each lane's write position); block_table: (B, max_blocks) int32 with
    -1 for unassigned ranges. Writes each lane's k/v into ``cache`` in
    place. Returns (logits (B, 1, V), cache).
    """
    _check_supported(cfg, opts)
    x = _embed_tokens(params, tokens, cfg)
    seq_lens = seq_lens.to(torch.int32)
    block_table = block_table.to(torch.int32)
    for i in range(cfg.num_layers):
        p = layer_slice(params["blocks"], i)
        c = layer_slice(cache["blocks"], i)
        h = layers.rmsnorm(p["ln1"], x, cfg.norm_eps)
        x = x + layers.decode_attention_paged(p["attn"], c, h, seq_lens, block_table, cfg)
        h = layers.rmsnorm(p["ln2"], x, cfg.norm_eps)
        x = x + layers.mlp(p["mlp"], h, cfg)
    return _unembed(params, x, cfg), cache
