"""The decoder's entry points (port of ``repro.models.transformer``):
``forward_hidden`` / ``forward_train`` (full-sequence training forward,
each layer under ``torch.utils.checkpoint`` when ``remat="full"``, and
keeping its projections' outputs when ``remat="dots"``),
``prefill`` (full-sequence forward that builds the dense KV cache, and
the SSM state of hybrid blocks), ``decode_step`` (one lock-step token
against that cache) and ``decode_step_paged`` (one continuous-batching
token per lane against the paged pool). The layer loop is a Python loop
over per-layer views of the stacked parameters.

Ported block families: DENSE with full attention (with or without a QKV
bias, and the VLM's stub vision prefix: ``batch["patches"]`` projected by
``vision_proj`` and prepended to the text), MOE (attention, then a
mixture of experts in place of the MLP) with full or sliding-window
attention, HYBRID_PARALLEL (Hymba: attention and a Mamba block side by
side, the selective scan differentiated by its backward kernel) with
sliding-window attention, and ENCDEC (whisper: a LayerNorm encoder over
``batch["frames"]``, the stub frontend's embeddings, whose output, the
``memory``, every decoder block cross-attends to after its self-attention;
the cache keeps it under ``memory``) with full attention, at every entry
point but the paged decode (DENSE text only, as in the reference); and
MLSTM or SLSTM (xLSTM, laid out alike as in the reference: ``groups`` of
mLSTM blocks and one sLSTM, no attention) at every entry point but the
paged decode: trained through the mLSTM's and the sLSTM's autograd
Functions (their backward kernels), each group under ``_maybe_remat``.
Either KV cache may be int8 (``RunOpts.int8_kv_cache``). Embeddings may be tied (the LM head is
``embed.T``, a view) and scaled by sqrt(d_model) as a float32 scalar, which
makes the residual stream f32 whatever the compute dtype, as in the
reference (gemma). Norms are LayerNorm for the ``audio`` family (whisper)
and RMSNorm otherwise. The other families raise ``NotImplementedError``.
"""
from __future__ import annotations

import dataclasses
import functools
from typing import Any, Callable, Dict, Tuple

import numpy as np
import torch
import torch.utils.checkpoint

from repro_torch.config.base import AttentionKind, BlockKind, ModelConfig
from repro_torch.models import common, layers, moe, ssm, xlstm
from repro_torch.models.common import ParamSpec


@dataclasses.dataclass(frozen=True)
class RunOpts:
    """Execution knobs from ``ShardingLayout`` that change how attention
    runs, not what it computes."""

    attn_impl: str = "masked"      # masked | triangular | flash
    q_chunk: int = 512
    kv_chunk: int = 1024
    remat: str = "full"            # none | full | dots
    int8_kv_cache: bool = False


_SERVED = {(BlockKind.DENSE, AttentionKind.FULL),
           (BlockKind.MOE, AttentionKind.FULL),
           (BlockKind.MOE, AttentionKind.SLIDING),
           (BlockKind.HYBRID_PARALLEL, AttentionKind.SLIDING),
           (BlockKind.MLSTM, AttentionKind.NONE),
           (BlockKind.SLSTM, AttentionKind.NONE),
           (BlockKind.ENCDEC, AttentionKind.FULL)}


# the xLSTM kinds: an SLSTM model is laid out as an MLSTM one (groups of
# mLSTM blocks, each group closed by an sLSTM block when ``slstm_every``)
_XLSTM = (BlockKind.MLSTM, BlockKind.SLSTM)


def _check_supported(cfg: ModelConfig, opts: RunOpts | None = None) -> None:
    if (cfg.block, cfg.attention) not in _SERVED:
        raise NotImplementedError(
            f"repro_torch serves DENSE full-attention, MOE full or sliding-window, "
            f"HYBRID_PARALLEL sliding-window, MLSTM, SLSTM and ENCDEC full-attention models only, "
            f"got {cfg.block.value}/{cfg.attention.value}"
        )
    if cfg.block == BlockKind.MOE and cfg.moe is None:
        raise NotImplementedError(f"repro_torch: {cfg.name} is MOE with no MoEConfig")
    if cfg.block == BlockKind.ENCDEC and not cfg.encoder_layers:
        raise NotImplementedError(f"repro_torch: {cfg.name}: ENCDEC blocks with no encoder")
    if opts is not None:
        if opts.attn_impl not in ("masked", "triangular", "flash"):
            raise NotImplementedError(f"repro_torch: attn_impl {opts.attn_impl!r}")
        if opts.remat not in ("none", "full", "dots"):
            raise NotImplementedError(f"repro_torch: remat {opts.remat!r}")


def _require_dense(cfg: ModelConfig, what: str) -> None:
    """The paged decode takes DENSE blocks only, as the reference pages
    DENSE blocks only: MOE, hybrid and encoder-decoder models serve through
    the dense ring cache, which carries their load counters, SSM states and
    encoder memory."""
    if cfg.block != BlockKind.DENSE:
        raise NotImplementedError(
            f"repro_torch: {what} supports DENSE blocks only, got {cfg.block.value}")


# ---------------------------------------------------------------------------
# Specs
# ---------------------------------------------------------------------------

def _norm_spec(cfg: ModelConfig) -> Dict[str, ParamSpec]:
    """LayerNorm for whisper (the ``audio`` family), RMSNorm otherwise."""
    if cfg.family == "audio":
        return layers.layernorm_spec(cfg.d_model)
    return layers.rmsnorm_spec(cfg.d_model)


def block_spec(cfg: ModelConfig) -> Dict[str, Any]:
    """Spec for ONE decoder block of this config's kind (unstacked)."""
    spec: Dict[str, Any] = {"ln1": _norm_spec(cfg), "attn": layers.attention_spec(cfg)}
    if cfg.block == BlockKind.HYBRID_PARALLEL:
        spec["mamba"] = ssm.mamba_spec(cfg)
        spec["fuse_attn"] = layers.rmsnorm_spec(cfg.d_model)
        spec["fuse_ssm"] = layers.rmsnorm_spec(cfg.d_model)
    spec["ln2"] = _norm_spec(cfg)
    if cfg.block == BlockKind.MOE:
        spec["moe"] = moe.moe_spec(cfg)
    else:
        spec["mlp"] = layers.mlp_spec(cfg)
    if cfg.block == BlockKind.ENCDEC:
        spec["ln_cross"] = _norm_spec(cfg)
        spec["cross"] = layers.attention_spec(cfg, cross=True)
    return spec


def _xlstm_group_layout(cfg: ModelConfig) -> Tuple[int, int, int]:
    """(n_groups, mlstm_per_group, has_slstm)."""
    if cfg.slstm_every:
        per = cfg.slstm_every
        if cfg.num_layers % per:
            raise ValueError(f"{cfg.name}: {cfg.num_layers} layers are not groups of {per}")
        return cfg.num_layers // per, per - 1, 1
    return 1, cfg.num_layers, 0


def _xlstm_groups(cfg: ModelConfig, mlstm_one: Any, slstm_one: Any) -> Dict[str, Any]:
    """``groups`` x {``mlstm``: ``layers`` x mlstm_one, ``slstm``: slstm_one}."""
    groups, m_per, has_s = _xlstm_group_layout(cfg)
    g: Dict[str, Any] = {"mlstm": common.stacked(mlstm_one, m_per)}
    if has_s:
        g["slstm"] = slstm_one
    return common.stacked(g, groups, axis_name="groups")


def model_specs(cfg: ModelConfig) -> Dict[str, Any]:
    _check_supported(cfg)
    d = cfg.d_model
    spec: Dict[str, Any] = {
        "embed": ParamSpec((cfg.vocab_size, d), ("vocab", "embed"), init="embed"),
        "final_norm": _norm_spec(cfg),
    }
    if not cfg.tie_embeddings:
        spec["lm_head"] = ParamSpec((d, cfg.vocab_size), ("embed", "vocab"))
    if cfg.block in _XLSTM:
        spec["groups"] = _xlstm_groups(
            cfg, {"block": xlstm.mlstm_spec(cfg), "ln": layers.rmsnorm_spec(d)},
            {"block": xlstm.slstm_spec(cfg), "ln": layers.rmsnorm_spec(d)})
    else:
        spec["blocks"] = common.stacked(block_spec(cfg), cfg.num_layers)
    if cfg.encoder_layers:  # whisper's encoder: self-attention (not causal) and the MLP
        enc_block = {"ln1": _norm_spec(cfg), "attn": layers.attention_spec(cfg),
                     "ln2": _norm_spec(cfg), "mlp": layers.mlp_spec(cfg)}
        spec["encoder"] = {"blocks": common.stacked(enc_block, cfg.encoder_layers),
                           "final_norm": _norm_spec(cfg)}
    if cfg.vision_tokens:  # the VLM's stub projector
        spec["vision_proj"] = ParamSpec((cfg.vision_width, d), ("vit_embed", "embed"))
    return spec


def cache_len_for(cfg: ModelConfig, seq_len: int) -> int:
    """Dense cache length: the sequence plus a VLM's vision prefix, or for
    sliding-window attention at most the window (a ring buffer), rounded up
    to a multiple of 16."""
    n = seq_len + cfg.vision_tokens
    if cfg.attention == AttentionKind.SLIDING and cfg.window:
        n = min(n, cfg.window)
    return -(-n // 16) * 16


def cache_specs(cfg: ModelConfig, batch: int, seq_len: int, int8: bool = False) -> Dict[str, Any]:
    """Dense cache specs, stacked over layers: k, v, pos_ids (with
    ``int8``: int8 k and v and their ``k_scale`` / ``v_scale``), the hybrid
    block's SSM state under ``ssm`` and the MoE block's int32 expert
    counters under ``moe_load``; an encoder-decoder's encoder output
    (B, encoder_seq_len, d) under ``memory``, beside ``blocks``; for xLSTM
    the recurrent states under ``groups`` (``seq_len`` and ``int8`` unused:
    the state is constant per token)."""
    _check_supported(cfg)
    if cfg.block in _XLSTM:
        return {"groups": _xlstm_groups(cfg, xlstm.mlstm_state_spec(cfg, batch),
                                        xlstm.slstm_state_spec(cfg, batch))}
    one: Dict[str, Any] = layers.make_cache_specs(cfg, batch, cache_len_for(cfg, seq_len),
                                                  int8=int8)
    if cfg.block == BlockKind.HYBRID_PARALLEL:
        one["ssm"] = ssm.init_state(cfg, batch)
    if cfg.block == BlockKind.MOE:
        one["moe_load"] = moe.moe_load_spec(cfg, batch)
    out: Dict[str, Any] = {"blocks": common.stacked(one, cfg.num_layers)}
    if cfg.encoder_layers:
        out["memory"] = ParamSpec((batch, cfg.encoder_seq_len, cfg.d_model),
                                  ("batch", "seq", "embed"), init="zeros", dtype=cfg.dtype)
    return out


def init_cache(cfg: ModelConfig, batch: int, seq_len: int, device,
               int8: bool = False) -> Dict[str, Any]:
    """An empty cache: zeros, and ``pos_ids = -1`` (no slot filled) where
    there is a KV cache."""
    cache = common.tree_map(
        lambda s: torch.zeros(s.shape, dtype=common.torch_dtype(s.dtype), device=device),
        cache_specs(cfg, batch, seq_len, int8=int8),
    )
    if "blocks" in cache:
        cache["blocks"]["pos_ids"].fill_(-1)
    return cache


def paged_cache_specs(
    cfg: ModelConfig, num_pages: int, page_size: int = layers.PAGE_SIZE, int8: bool = False,
) -> Dict[str, Any]:
    """Paged KV pool specs, stacked over layers (serving decode engine)."""
    _check_supported(cfg)
    _require_dense(cfg, "the paged KV cache")
    one = layers.make_paged_cache_specs(cfg, num_pages, page_size, int8=int8)
    return {"blocks": common.stacked(one, cfg.num_layers)}


def init_paged_cache(
    cfg: ModelConfig, num_pages: int, device, page_size: int = layers.PAGE_SIZE,
    int8: bool = False,
) -> Dict[str, Any]:
    specs = paged_cache_specs(cfg, num_pages, page_size, int8=int8)
    return common.tree_map(
        lambda s: torch.zeros(s.shape, dtype=common.torch_dtype(s.dtype), device=device),
        specs,
    )


def layer_slice(tree: Dict[str, Any], i: int) -> Dict[str, Any]:
    """Layer ``i`` of a stacked tree: views, so in-place writes land in it."""
    return common.tree_map(lambda t: t[i], tree)


def per_layer(params: Dict[str, Any], n: int, fn: Callable = lambda t: t) -> Dict[str, Any]:
    """``params`` with ``fn`` applied to each top-level leaf and to each
    layer slice of the stacked ``blocks``, which become a list of n trees;
    an xLSTM's ``groups`` become a list of its groups, each with its
    ``mlstm`` blocks as a list of per-layer trees and its ``slstm`` block.

    The train step differentiates ``per_layer(params, n, lambda t:
    t.detach().requires_grad_())``: leaves that share the stacked storage,
    each with its own ``.grad``. Differentiating through ``layer_slice`` of
    a stacked leaf instead would add a zero-filled gradient of the WHOLE
    leaf for every layer.
    """
    out = {k: common.tree_map(fn, v) for k, v in params.items() if k not in ("blocks", "groups")}
    if "groups" in params:
        out["groups"] = []
        for g in range(common.tree_leaves(params["groups"])[0].shape[0]):
            grp = layer_slice(params["groups"], g)
            one = {"mlstm": [common.tree_map(fn, layer_slice(grp["mlstm"], i))
                             for i in range(common.tree_leaves(grp["mlstm"])[0].shape[0])]}
            if "slstm" in grp:
                one["slstm"] = common.tree_map(fn, grp["slstm"])
            out["groups"].append(one)
    else:
        out["blocks"] = [common.tree_map(fn, layer_slice(params["blocks"], i)) for i in range(n)]
    return out


# ---------------------------------------------------------------------------
# Blocks
# ---------------------------------------------------------------------------

def _attn_full(params, h, positions, cfg: ModelConfig, opts: RunOpts):
    """Self-attention returning the output and the roped (k, v) to cache."""
    q, k, v = layers._project_qkv(params, h, h, cfg)
    q = layers.rope(q, positions, cfg.rope_theta)
    k = layers.rope(k, positions, cfg.rope_theta)
    window = cfg.window if cfg.attention == AttentionKind.SLIDING else 0
    if opts.attn_impl == "flash":
        # the CUDA flash kernel on a GPU tensor, its plain version on the CPU
        from repro_torch.kernels.flash_attention import flash_attention

        out = flash_attention(q, k, v, True, window, 0)
    else:
        out = layers.blockwise_attention(
            q, k, v, causal=True, window=window, q_chunk=opts.q_chunk, kv_chunk=opts.kv_chunk,
            impl=opts.attn_impl,
        )
    B, S = h.shape[:2]
    out = out.reshape(B, S, cfg.q_dim)
    return common.dense(out, params["wo"], cfg.dtype), (k, v)


def _kv_to_cache(kv, positions, cache_len: int, int8: bool,
                 scale_dtype: torch.dtype) -> Dict[str, torch.Tensor]:
    """Write the last ``cache_len`` positions of (k, v) into a fresh cache;
    ``int8``: as codes, with their scales in ``scale_dtype``, quantized
    after the ring layout as the reference does."""
    k, v = kv
    S = k.shape[1]
    T = cache_len
    if S >= T:
        kc, vc = k[:, S - T:], v[:, S - T:]
        pos_ids = positions[0, S - T:].to(torch.int32)
        order = torch.argsort(pos_ids % T, stable=True)   # ring layout: slot = pos % T
        out = {"k": kc[:, order], "v": vc[:, order], "pos_ids": pos_ids[order]}
    else:
        pad = T - S
        pad_kv = (0, 0, 0, 0, 0, pad)
        pos_ids = torch.cat([
            positions[0].to(torch.int32),
            torch.full((pad,), -1, dtype=torch.int32, device=k.device),
        ])
        out = {"k": torch.nn.functional.pad(k, pad_kv),
               "v": torch.nn.functional.pad(v, pad_kv), "pos_ids": pos_ids}
    if int8:
        for key in ("k", "v"):
            out[key], scale = layers._quantize_kv(out[key])
            out[key + "_scale"] = scale.to(scale_dtype)
    return out


def _fuse(p, attn_out: torch.Tensor, ssm_out: torch.Tensor, cfg: ModelConfig) -> torch.Tensor:
    """Hymba's fusion of its parallel heads: the mean of the two normed outputs."""
    return 0.5 * (layers.rmsnorm(p["fuse_attn"], attn_out, cfg.norm_eps)
                  + layers.rmsnorm(p["fuse_ssm"], ssm_out, cfg.norm_eps))


def _stack(trees: list) -> Any:
    """Stack a list of equal trees (nested dicts of tensors) leaf by leaf."""
    if isinstance(trees[0], dict):
        return {k: _stack([t[k] for t in trees]) for k in trees[0]}
    return torch.stack(trees)


def _copy_into(dst: Any, src: Any) -> None:
    """Write a tree of new states into a cache slice of the same tree, in place."""
    if isinstance(dst, dict):
        for key in dst:
            _copy_into(dst[key], src[key])
    else:
        dst.copy_(src)


def _xlstm_group(p, x: torch.Tensor, cfg: ModelConfig, cache=None):
    """One xLSTM super-block: its mLSTM blocks, then its sLSTM block if it
    has one, each added to the residual stream after an RMSNorm. ``p`` is
    the group's slice of ``groups``, or ``per_layer``'s form of it (its
    ``mlstm`` a list of per-layer trees).

    ``cache`` is the group's slice of the cache (decode: each block starts
    from its state there, and its new state is written back IN PLACE), or
    None (prefill: every block starts from zeros). Returns (x, the group's
    new states stacked over its mLSTM blocks as the cache is; None in
    decode, where they are in ``cache``)."""
    new_m, new_s = [], None
    m_layers = p["mlstm"]
    if not isinstance(m_layers, list):
        m_layers = [layer_slice(m_layers, i)
                    for i in range(common.tree_leaves(m_layers)[0].shape[0])]
    for i, pi in enumerate(m_layers):
        st = None if cache is None else layer_slice(cache["mlstm"], i)
        h, state = xlstm.mlstm_block(pi["block"], layers.rmsnorm(pi["ln"], x, cfg.norm_eps),
                                     cfg, st)
        x = x + h
        if st is None:
            new_m.append(state)
        else:
            _copy_into(st, state)
    if "slstm" in p:
        st = None if cache is None else cache["slstm"]
        h, new_s = xlstm.slstm_block(
            p["slstm"]["block"], layers.rmsnorm(p["slstm"]["ln"], x, cfg.norm_eps), cfg, st)
        x = x + h
        if st is not None:
            _copy_into(st, new_s)
    if cache is not None:
        return x, None
    out = {"mlstm": _stack(new_m)}
    if new_s is not None:
        out["slstm"] = new_s
    return x, out


def _ffn(p, h: torch.Tensor, cfg: ModelConfig):
    """The block's feed-forward half: (out, aux_loss f32, moe_load or None);
    the MoE block's experts in place of the MLP."""
    if cfg.block == BlockKind.MOE:
        return moe.moe_block(p["moe"], h, cfg)
    return layers.mlp(p["mlp"], h, cfg), torch.zeros((), dtype=torch.float32, device=h.device), None


def _embed_tokens(params, tokens: torch.Tensor, cfg: ModelConfig) -> torch.Tensor:
    """The rows of ``tokens`` in the compute dtype; with ``embed_scale``
    times sqrt(d_model) rounded to float32, in f32: the reference multiplies
    by a numpy float32 scalar, which promotes a bf16 operand to f32, so the
    residual stream (every norm and ``x + h`` after it) runs in f32."""
    x = params["embed"][tokens.long()].to(common.torch_dtype(cfg.dtype))
    if cfg.embed_scale:
        x = x.float() * float(np.sqrt(cfg.d_model).astype(np.float32))
    return x


def _embed_inputs(params, batch, cfg: ModelConfig):
    """tokens, after a VLM's projected ``batch["patches"]`` (B, P,
    vision_width) -> (x, positions over both, the encoder's output over
    ``batch["frames"]`` (B, encoder_seq_len, d) or None, n_prefix = P or 0)."""
    x = _embed_tokens(params, batch["tokens"], cfg)
    ct = common.torch_dtype(cfg.dtype)
    n_prefix = 0
    if cfg.vision_tokens:
        prefix = common.dense(batch["patches"].to(ct), params["vision_proj"], ct)
        x = torch.cat([prefix, x], dim=1)
        n_prefix = prefix.shape[1]
    B, S = x.shape[:2]
    positions = torch.arange(S, dtype=torch.int32, device=x.device).expand(B, S)
    memory = None
    if cfg.encoder_layers:
        memory = _run_encoder(params["encoder"], batch["frames"].to(ct), cfg)
    return x, positions, memory, n_prefix


def _run_encoder(enc, frames: torch.Tensor, cfg: ModelConfig) -> torch.Tensor:
    """whisper's encoder over the stub frontend's frame embeddings (B, T, d):
    per layer, self-attention with RoPE over the frames, not causal, through
    the plain blockwise attention at the reference's fixed 512 / 512 chunks
    (1500 frames are padded to 1536, the pad rows masked), then the MLP,
    each after its norm and added to the residual; then the final norm.
    Plain PyTorch on every device: the reference computes it outside any
    kernel."""
    B, T, _ = frames.shape
    positions = torch.arange(T, dtype=torch.int32, device=frames.device).expand(B, T)
    x = frames
    for i in range(common.tree_leaves(enc["blocks"])[0].shape[0]):
        p = layer_slice(enc["blocks"], i)
        h = layers.norm(p["ln1"], x, cfg)
        q, k, v = layers._project_qkv(p["attn"], h, h, cfg)
        q = layers.rope(q, positions, cfg.rope_theta)
        k = layers.rope(k, positions, cfg.rope_theta)
        out = layers.blockwise_attention(q, k, v, causal=False, q_chunk=512, kv_chunk=512)
        x = x + common.dense(out.reshape(B, T, cfg.q_dim), p["attn"]["wo"], cfg.dtype)
        h = layers.norm(p["ln2"], x, cfg)
        x = x + layers.mlp(p["mlp"], h, cfg)
    return layers.norm(enc["final_norm"], x, cfg)


def _unembed(params, x: torch.Tensor, cfg: ModelConfig) -> torch.Tensor:
    x = layers.norm(params["final_norm"], x, cfg)
    return common.dense(x, unembed_weight(params, cfg), cfg.dtype)


# the products that ``dense`` (``torch.matmul`` of a 2-D weight, folded to
# one matrix product) dispatches on either device: no batch dimension
_DOTS = (torch.ops.aten.mm.default, torch.ops.aten.addmm.default)


def _save_dots(ctx, op, *args, **kwargs):
    """``remat="dots"``'s policy, the counterpart of JAX's
    ``checkpoint_dots_with_no_batch_dims``: keep the outputs of the matrix
    products with no batch dimension (the projections) and recompute
    everything else: batched products (``bmm``: attention's scores and
    the experts'), every elementwise op, and the kernels' autograd
    Functions, whose forwards run with grad mode off (a product inside
    one, the plain versions' on the CPU, is theirs, not a projection)."""
    from torch.utils.checkpoint import CheckpointPolicy

    if op in _DOTS and torch.is_grad_enabled():
        return CheckpointPolicy.MUST_SAVE
    return CheckpointPolicy.PREFER_RECOMPUTE


def _maybe_remat(fn, opts: RunOpts):
    """``remat="full"``: keep only each call's inputs and recompute the
    rest in backward (``jax.checkpoint``'s counterpart); ``"dots"``: keep
    the projections' outputs too (``_save_dots``)."""
    if opts.remat == "none":
        return fn
    if opts.remat == "dots":
        from torch.utils.checkpoint import create_selective_checkpoint_contexts

        context = functools.partial(create_selective_checkpoint_contexts, _save_dots)
        return lambda *args: torch.utils.checkpoint.checkpoint(
            fn, *args, use_reentrant=False, context_fn=context)
    return lambda *args: torch.utils.checkpoint.checkpoint(fn, *args, use_reentrant=False)


def _block(p, x: torch.Tensor, positions: torch.Tensor, cfg: ModelConfig, opts: RunOpts,
           memory=None, cache_len: int = 0, cache_dtype=None):
    """One decoder block over a full sequence (training and prefill):
    self-attention, beside it a hybrid block's Mamba half, then an
    encoder-decoder block's cross-attention over ``memory``, then the MLP
    or the experts, each after its norm and added to the residual. Returns
    (x, aux_loss f32, this layer's cache entry when ``cache_len`` is set,
    else None)."""
    h = layers.norm(p["ln1"], x, cfg)
    attn_out, kv = _attn_full(p["attn"], h, positions, cfg, opts)
    c = (_kv_to_cache(kv, positions, cache_len, opts.int8_kv_cache, cache_dtype)
         if cache_len else None)
    if cfg.block == BlockKind.HYBRID_PARALLEL:
        ssm_out, state = ssm.mamba_block(p["mamba"], h, cfg)
        x = x + _fuse(p, attn_out, ssm_out, cfg)
        if c is not None:
            c["ssm"] = state
    else:
        x = x + attn_out
    if cfg.block == BlockKind.ENCDEC:
        h = layers.norm(p["ln_cross"], x, cfg)
        x = x + layers.cross_attention_layer(p["cross"], h, memory, cfg)
    h = layers.norm(p["ln2"], x, cfg)
    out, aux, load = _ffn(p, h, cfg)
    if load is not None and c is not None:
        c["moe_load"] = load
    return x + out, aux, c


# ---------------------------------------------------------------------------
# Drivers
# ---------------------------------------------------------------------------

def forward_hidden(params, batch, cfg: ModelConfig, opts: RunOpts):
    """Full-sequence forward up to (but excluding) the LM head.

    Returns (normed hidden states over the TEXT positions (B, S, d),
    aux_loss) — the fused
    cross-entropy in ``train/steps.py`` consumes this and never materializes
    the full (B, S, vocab) logits. ``params["blocks"]`` (an xLSTM's
    ``groups``) is the stacked tree or, to differentiate, ``per_layer``'s
    lists of per-layer trees. Each decoder layer (each xLSTM group, as the
    reference remats it) runs under ``_maybe_remat``; an encoder runs once,
    before them, outside it (as in the reference).
    """
    _check_supported(cfg, opts)
    x, positions, memory, n_prefix = _embed_inputs(params, batch, cfg)
    if cfg.block in _XLSTM:
        groups = params["groups"]
        if not isinstance(groups, list):
            groups = [layer_slice(groups, g) for g in range(_xlstm_group_layout(cfg)[0])]
        group = _maybe_remat(lambda xx, p: _xlstm_group(p, xx, cfg)[0], opts)
        for p in groups:
            x = group(x, p)
        x = layers.norm(params["final_norm"], x[:, n_prefix:], cfg)
        return x, torch.zeros((), dtype=torch.float32, device=x.device)
    blocks = params["blocks"]
    if not isinstance(blocks, list):
        blocks = [layer_slice(blocks, i) for i in range(cfg.num_layers)]

    def body(xx, p):
        xx, aux, _ = _block(p, xx, positions, cfg, opts, memory)
        return xx, aux

    body = _maybe_remat(body, opts)
    auxes = []
    for p in blocks:
        x, aux = body(x, p)
        auxes.append(aux)
    x = layers.norm(params["final_norm"], x[:, n_prefix:], cfg)
    return x, torch.stack(auxes).sum()


def unembed_weight(params, cfg: ModelConfig) -> torch.Tensor:
    """(d, vocab) projection: with tied embeddings ``embed.T``, a view (no
    copy of the vocab x d table; its gradient lands in ``embed``'s)."""
    if cfg.tie_embeddings:
        return params["embed"].T
    return params["lm_head"]


def forward_train(params, batch, cfg: ModelConfig, opts: RunOpts):
    """Full-sequence forward. Returns (logits over the TEXT positions
    (B, S, V), aux_loss)."""
    x, aux = forward_hidden(params, batch, cfg, opts)
    return common.dense(x, unembed_weight(params, cfg), cfg.dtype), aux


def prefill(params, batch, cfg: ModelConfig, opts: RunOpts, cache_seq_len: int):
    """Forward + cache build. ``batch["tokens"]``: (B, S) int (a VLM's
    ``batch["patches"]`` go before them; an encoder-decoder's
    ``batch["frames"]`` feed its encoder). Returns (last-position logits
    (B, 1, V), cache): k/v of the last ``cache_len_for(cfg, cache_seq_len)``
    positions in ring-buffer slots (``opts.int8_kv_cache``: int8 codes and
    their scales, quantized layer by layer, so no whole-depth cache of the
    compute dtype is ever held), ``pos_ids``, for hybrid blocks the SSM
    state under ``ssm``, for MoE blocks each sequence's expert counters
    under ``moe_load``, and an encoder's output under ``memory``; for xLSTM
    the recurrent states under ``groups``."""
    _check_supported(cfg, opts)
    x, positions, memory, _ = _embed_inputs(params, batch, cfg)
    if cfg.block in _XLSTM:
        states = []
        for g in range(_xlstm_group_layout(cfg)[0]):
            x, st = _xlstm_group(layer_slice(params["groups"], g), x, cfg)
            states.append(st)
        return _unembed(params, x[:, -1:, :], cfg), {"groups": _stack(states)}
    T = cache_len_for(cfg, cache_seq_len)
    caches = []
    for i in range(cfg.num_layers):
        x, _, c = _block(layer_slice(params["blocks"], i), x, positions, cfg, opts, memory,
                         T, common.torch_dtype(cfg.dtype))
        caches.append(c)
    cache = {"blocks": _stack(caches)}
    if memory is not None:
        cache["memory"] = memory
    return _unembed(params, x[:, -1:, :], cfg), cache


def decode_step(params, cache, tokens, pos: int, cfg: ModelConfig, opts: RunOpts):
    """One lock-step decode step against the dense cache.

    tokens: (B, 1) int; pos: the TEXT position of the new token (the same
    for every row; a VLM's vision prefix is added here, since prefill
    placed the text after it). Writes the token's k/v into its ring slot, the
    new SSM state of hybrid blocks, the MoE blocks' expert counters and the
    new xLSTM states into ``cache`` IN PLACE (the reference returns an
    updated copy); an encoder-decoder block cross-attends to the cache's
    ``memory``, which stays as prefill left it. Returns (logits (B, 1, V),
    cache).
    """
    _check_supported(cfg, opts)
    pos = int(pos) + cfg.vision_tokens
    x = _embed_tokens(params, tokens, cfg)
    if cfg.block in _XLSTM:
        for g in range(_xlstm_group_layout(cfg)[0]):
            x, _ = _xlstm_group(layer_slice(params["groups"], g), x, cfg,
                                layer_slice(cache["groups"], g))
        return _unembed(params, x, cfg), cache
    memory = cache.get("memory")
    for i in range(cfg.num_layers):
        p = layer_slice(params["blocks"], i)
        c = layer_slice(cache["blocks"], i)
        h = layers.norm(p["ln1"], x, cfg)
        attn_out, _ = layers.decode_attention(p["attn"], c, h, pos, cfg)
        if cfg.block == BlockKind.HYBRID_PARALLEL:
            ssm_out, state = ssm.mamba_decode_step(p["mamba"], h, c["ssm"], cfg)
            _copy_into(c["ssm"], state)
            x = x + _fuse(p, attn_out, ssm_out, cfg)
        else:
            x = x + attn_out
        if cfg.block == BlockKind.ENCDEC:
            h = layers.norm(p["ln_cross"], x, cfg)
            x = x + layers.cross_attention_layer(p["cross"], h, memory, cfg)
        h = layers.norm(p["ln2"], x, cfg)
        if cfg.block == BlockKind.MOE:
            m_out, new_load = moe.moe_decode_block(p["moe"], h, c["moe_load"], pos, cfg)
            c["moe_load"].copy_(new_load)
            x = x + m_out
        else:
            x = x + layers.mlp(p["mlp"], h, cfg)
    return _unembed(params, x, cfg), cache


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
    _require_dense(cfg, "paged decode")
    x = _embed_tokens(params, tokens, cfg)
    seq_lens = seq_lens.to(torch.int32)
    block_table = block_table.to(torch.int32)
    for i in range(cfg.num_layers):
        p = layer_slice(params["blocks"], i)
        c = layer_slice(cache["blocks"], i)
        h = layers.norm(p["ln1"], x, cfg)
        x = x + layers.decode_attention_paged(p["attn"], c, h, seq_lens, block_table, cfg)
        h = layers.norm(p["ln2"], x, cfg)
        x = x + layers.mlp(p["mlp"], h, cfg)
    return _unembed(params, x, cfg), cache
