"""Train- and serve-step builders (port of ``repro.train.steps``).

``build_train_step`` returns ``(state, batch) -> (state, metrics)`` with
the reference's loss and update: fused chunked cross-entropy (the
(B, S, vocab) logits never exist), microbatch gradient accumulation,
optional bf16 gradients (``gradient_allreduce_dtype``), remat per layer,
global-norm clipping, warmup-cosine schedule and AdamW.

Unlike the JAX step it is not pure: the state's parameters and moments
are updated IN PLACE, and the returned state holds the same tensors. The
forward differentiates per-layer leaves that are views of the stacked
parameters, so each layer's gradient is its own tensor and accumulates
over microbatches in its ``.grad`` in f32; there is no second gradient
tree. Without ``jit``, the serve-step builders just bind the model,
layout and static arguments into a plain function.
"""
from __future__ import annotations

from typing import Any, Callable, Dict, List, NamedTuple, Tuple

import torch
import torch.utils.checkpoint

from repro_torch import resolve_device
from repro_torch.config.base import ShardingLayout, TrainConfig
from repro_torch.models import common, zoo
from repro_torch.models.transformer import RunOpts, per_layer
from repro_torch.optim import OptState, adamw_update, clip_by_global_norm, init_opt_state
from repro_torch.optim.schedule import warmup_cosine


class TrainState(NamedTuple):
    params: Any
    opt: OptState
    step: int


def init_train_state(model: zoo.Model, generator: torch.Generator, device="cuda") -> TrainState:
    """Random f32 params from ``generator`` (which must live on ``device``)
    and zero moments."""
    params = model.init(generator, resolve_device(device))
    return TrainState(params=params, opt=init_opt_state(params), step=0)


def run_opts_from_layout(layout: ShardingLayout) -> RunOpts:
    """``scan_layers`` has no counterpart: the layer loop is a Python loop."""
    return RunOpts(
        attn_impl=layout.attn_impl,
        q_chunk=layout.q_chunk,
        kv_chunk=layout.kv_chunk,
        remat=layout.remat,
        int8_kv_cache=layout.int8_kv_cache,
    )


# ---------------------------------------------------------------------------
# Loss
# ---------------------------------------------------------------------------

def _nll(logits: torch.Tensor, labels: torch.Tensor, label_smoothing: float) -> torch.Tensor:
    """Per-token negative log-likelihood of f32 logits (B, S, V)."""
    lse = torch.logsumexp(logits, dim=-1)
    gold = torch.gather(logits, -1, labels[..., None].long())[..., 0]
    nll = lse - gold
    if label_smoothing:
        smooth = lse - logits.mean(dim=-1)
        nll = (1.0 - label_smoothing) * nll + label_smoothing * smooth
    return nll


def cross_entropy(
    logits: torch.Tensor, labels: torch.Tensor, label_smoothing: float = 0.0
) -> torch.Tensor:
    """Token-mean CE over (B, S, V) logits, in f32."""
    return _nll(logits.float(), labels, label_smoothing).mean()


def chunked_cross_entropy(
    x: torch.Tensor,
    w: torch.Tensor,
    labels: torch.Tensor,
    chunk: int = 256,
    label_smoothing: float = 0.0,
) -> torch.Tensor:
    """Fused unembed + CE over sequence chunks, checkpointed per chunk.

    Forward holds one (B, chunk, V) slab at a time and backward recomputes
    it per chunk. ``w`` is cast to x's dtype inside each chunk, as the
    reference does, so its gradient sums over chunks in w's own dtype. A
    sequence that ``chunk`` does not divide is one slab.
    """
    B, S, _ = x.shape
    chunk = min(chunk, S)
    if S % chunk:
        chunk = S  # ragged fallback: single slab

    def body(xi, li):
        logits = torch.matmul(xi, w.to(xi.dtype)).float()
        return _nll(logits, li, label_smoothing).sum()

    total = torch.zeros((), dtype=torch.float32, device=x.device)
    for i in range(0, S, chunk):
        total = total + torch.utils.checkpoint.checkpoint(
            body, x[:, i:i + chunk], labels[:, i:i + chunk], use_reentrant=False)
    return total / (B * S)


# ---------------------------------------------------------------------------
# Train step
# ---------------------------------------------------------------------------

def build_train_step(
    model: zoo.Model,
    tc: TrainConfig,
    layout: ShardingLayout,
) -> Callable[[TrainState, Dict[str, torch.Tensor]], Tuple[TrainState, Dict[str, torch.Tensor]]]:
    opts = run_opts_from_layout(layout)
    compress = layout.gradient_allreduce_dtype == "bfloat16"
    n_layers = model.cfg.num_layers

    def loss_fn(params, batch):
        if compress:
            params = common.tree_map(
                lambda p: p.to(torch.bfloat16) if p.is_floating_point() else p, params)
        if layout.fused_ce:
            x, aux = model.forward_hidden(params, batch, opts)
            loss = chunked_cross_entropy(
                x, model.unembed_weight(params), batch["labels"],
                layout.ce_chunk, tc.label_smoothing,
            )
        else:
            logits, aux = model.forward(params, batch, opts)
            loss = cross_entropy(logits, batch["labels"], tc.label_smoothing)
        return loss + aux, loss, aux

    def train_step(state: TrainState, batch: Dict[str, torch.Tensor]):
        if state.params["embed"].device.type == "cuda" and layout.attn_impl not in (
                "flash", "triangular"):
            # triangular is the reference's causal chunk schedule, plain
            # attention by design (the reference has no kernel for it)
            raise ValueError(
                f"the train step on CUDA attends with the flash kernels: "
                f"layout.attn_impl must be 'flash' (or 'triangular'), got {layout.attn_impl!r}"
            )
        # leaves that share the params' storage, each with its own .grad
        leaves = per_layer(state.params, n_layers, lambda t: t.detach().requires_grad_())
        b = batch["tokens"].shape[0]
        if b % tc.microbatches:
            raise ValueError(f"batch {b} is not a multiple of {tc.microbatches} microbatches")
        rows = b // tc.microbatches
        loss_sum = aux_sum = 0.0
        for i in range(tc.microbatches):
            mb = {k: v[i * rows:(i + 1) * rows] for k, v in batch.items()}
            total, loss, aux = loss_fn(leaves, mb)
            total.backward()
            loss_sum = loss_sum + loss.detach()
            aux_sum = aux_sum + aux.detach()
        grads: List[torch.Tensor] = [t.grad for t in common.tree_flatten(leaves)[0]]
        if tc.microbatches > 1:
            scale = 1.0 / tc.microbatches
            for g in grads:
                g.mul_(scale)
            loss_sum, aux_sum = loss_sum * scale, aux_sum * scale
        del leaves

        grads, grad_norm = clip_by_global_norm(grads, tc.grad_clip)
        lr = warmup_cosine(state.step, tc)
        flat = lambda tree: common.tree_flatten(per_layer(tree, n_layers))[0]
        opt = OptState(m=flat(state.opt.m), v=flat(state.opt.v), count=state.opt.count)
        _, opt = adamw_update(grads, opt, flat(state.params), lr, tc)
        metrics = {
            "loss": loss_sum.float(),
            "aux_loss": aux_sum.float(),
            "grad_norm": grad_norm,
            "lr": torch.tensor(lr, dtype=torch.float32),
        }
        new_opt = OptState(m=state.opt.m, v=state.opt.v, count=opt.count)
        return TrainState(state.params, new_opt, state.step + 1), metrics

    return train_step


# ---------------------------------------------------------------------------
# Serve steps
# ---------------------------------------------------------------------------

def build_prefill_step(model: zoo.Model, layout: ShardingLayout, cache_seq_len: int):
    opts = run_opts_from_layout(layout)

    def prefill_step(params, batch):
        return model.prefill(params, batch, cache_seq_len, opts)

    return prefill_step


def build_decode_step(model: zoo.Model, layout: ShardingLayout):
    """(params, cache, tokens (B,1), pos) -> (logits, cache); the dense
    cache is updated in place."""
    opts = run_opts_from_layout(layout)

    def decode_step(params, cache, tokens, pos):
        return model.decode_step(params, cache, tokens, pos, opts)

    return decode_step


def build_paged_decode_step(model: zoo.Model, layout: ShardingLayout):
    """(params, cache, tokens (B,1), seq_lens (B,), block_table (B,nb))
    -> (logits, cache); the pool is updated in place."""
    opts = run_opts_from_layout(layout)

    def paged_decode_step(params, cache, tokens, seq_lens, block_table):
        return model.decode_step_paged(params, cache, tokens, seq_lens, block_table, opts)

    return paged_decode_step
