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

def _loss_fn(model: zoo.Model, tc: TrainConfig, layout: ShardingLayout):
    opts = run_opts_from_layout(layout)
    compress = layout.gradient_allreduce_dtype == "bfloat16"

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

    return loss_fn


def _check_attention(params, layout: ShardingLayout) -> None:
    if params["embed"].device.type == "cuda" and layout.attn_impl not in ("flash", "triangular"):
        # triangular is the reference's causal chunk schedule, plain
        # attention by design (the reference has no kernel for it)
        raise ValueError(
            f"the train step on CUDA attends with the flash kernels: "
            f"layout.attn_impl must be 'flash' (or 'triangular'), got {layout.attn_impl!r}"
        )


def _backward(loss_fn, leaves, batch: Dict[str, torch.Tensor], microbatches: int):
    """Forward and backward over ``microbatches`` equal slices of the
    batch's rows; gradients accumulate in the leaves' ``.grad``. Returns
    the summed (loss, aux) of the microbatches."""
    b = batch["tokens"].shape[0]
    if b % microbatches:
        raise ValueError(f"batch {b} is not a multiple of {microbatches} microbatches")
    rows = b // microbatches
    loss_sum = aux_sum = 0.0
    for i in range(microbatches):
        mb = {k: v[i * rows:(i + 1) * rows] for k, v in batch.items()}
        total, loss, aux = loss_fn(leaves, mb)
        total.backward()
        loss_sum = loss_sum + loss.detach()
        aux_sum = aux_sum + aux.detach()
    return loss_sum, aux_sum


def build_train_step(
    model: zoo.Model,
    tc: TrainConfig,
    layout: ShardingLayout,
) -> Callable[[TrainState, Dict[str, torch.Tensor]], Tuple[TrainState, Dict[str, torch.Tensor]]]:
    loss_fn = _loss_fn(model, tc, layout)
    n_layers = model.cfg.num_layers

    def train_step(state: TrainState, batch: Dict[str, torch.Tensor]):
        _check_attention(state.params, layout)
        # leaves that share the params' storage, each with its own .grad
        leaves = per_layer(state.params, n_layers, lambda t: t.detach().requires_grad_())
        loss_sum, aux_sum = _backward(loss_fn, leaves, batch, tc.microbatches)
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


def build_sharded_train_step(model: zoo.Model, tc: TrainConfig, layout: ShardingLayout, mesh):
    """The train step on a plan of several ranks (a distributed
    ``SlotMesh``), run by every rank of the plan alike. Each rank holds its
    slices of the params and both moments by ``param_shardings`` (the
    reference's ``make_jitted_step`` placements) and

    * gathers the whole params (once a step, the whole tree);
    * runs the forward and backward on its rows of the batch
      (``batch_shardings``: the ranks of one ``data`` coordinate share
      rows, since the ``model`` axis shards storage only), in
      ``microbatches / data`` microbatches of the global step's size;
    * sums the gradients over the ``data`` axis into its slices, in rank
      order (``dist.elastic.reduce_over_data``), and clips them by the
      global norm, summed over distinct slices in rank order;
    * updates only its slices with AdamW, in place.

    Every collective's order is fixed, so a step re-run from the same state
    gives the same bits. The loss is the mean of the data coordinates'."""
    from repro_torch.dist import elastic
    from repro_torch.dist.sharding import batch_shardings, param_shardings, replicated
    from repro_torch.launch.mesh import group_for, world

    loss_fn = _loss_fn(model, tc, layout)
    n_layers = model.cfg.num_layers
    me = world().rank
    group = group_for(mesh.slots)
    spec_leaves, _ = common.tree_flatten(model.specs)
    shapes = [tuple(s.shape) for s in spec_leaves]
    p_sh = common.tree_flatten(param_shardings(model.specs, mesh, layout))[0]
    whole = [replicated(mesh)] * len(p_sh)
    firsts = [elastic.first_holder(p, sh) for p, sh in zip(p_sh, shapes)]
    data = mesh.shape.get("data", 1)
    leaders = elastic.data_leaders(mesh)

    def train_step(state: TrainState, batch: Dict[str, torch.Tensor]):
        flat_p, unflatten = common.tree_flatten(state.params)
        full, _ = elastic.move_leaves(flat_p, p_sh, whole, group=group)
        params = unflatten(full)
        _check_attention(params, layout)
        # the stacked gradient of every leaf; the per-layer leaves' .grad
        # are its views, so backward accumulates into it
        grads = [torch.zeros_like(t) for t in full]
        leaves = per_layer(params, n_layers, lambda t: t.detach().requires_grad_())
        for t, g in zip(common.tree_flatten(leaves)[0],
                        common.tree_flatten(per_layer(unflatten(grads), n_layers))[0]):
            t.grad = g
        del full, params
        b = batch["tokens"].shape[0]
        lo, hi = batch_shardings(batch, mesh)["tokens"].box(batch["tokens"].shape, me)[0]
        mine = {k: v[lo:hi] for k, v in batch.items()}
        local_mb = max(1, tc.microbatches * (hi - lo) // b)
        loss_sum, aux_sum = _backward(loss_fn, leaves, mine, local_mb)
        del leaves

        scale = 1.0 / (local_mb * data)
        slices = []
        for i, (g, p) in enumerate(zip(grads, p_sh)):
            mine_g = elastic.reduce_over_data(g, p, group)
            grads[i] = None
            slices.append(mine_g.mul_(scale))
        sq = torch.stack([
            torch.linalg.vector_norm(g, dtype=torch.float32).square() if first
            else torch.zeros((), dtype=torch.float32, device=g.device)
            for g, first in zip(slices, firsts)])
        grad_norm = elastic.gather_rows(sq, group).sum(dim=0).sum().sqrt()
        clip = torch.clamp(tc.grad_clip / torch.clamp(grad_norm, min=1e-9), max=1.0)
        for g in slices:
            g.mul_(clip.to(g.dtype))
        losses = elastic.gather_rows(torch.stack([loss_sum, aux_sum]).float().reshape(2),
                                     group)
        at = [list(mesh.slots).index(r) for r in leaders]
        mean = losses[at].sum(dim=0) * (1.0 / (local_mb * data))

        lr = warmup_cosine(state.step, tc)
        flat = lambda tree: common.tree_flatten(tree)[0]
        opt = OptState(m=flat(state.opt.m), v=flat(state.opt.v), count=state.opt.count)
        _, opt = adamw_update(slices, opt, flat_p, lr, tc)
        metrics = {
            "loss": mean[0],
            "aux_loss": mean[1],
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
