"""AdamW with decoupled weight decay + global-norm clipping, in place.

The arithmetic is the reference's (``repro/optim/adamw.py``): bias
correction ``1 - b ** count`` in f32, eps after the sqrt, decoupled decay
on the f32 parameter inside ``lr * (...)``. Unlike the JAX functions,
these update the parameters, moments and gradients IN PLACE, one piece of
at most ``CHUNK`` elements at a time: at full width (4.4 B f32 params)
the params, grads and both moments fill most of an 80 GB card, so a
functional update (new p, m, v per leaf) or an out-of-place clip does not
fit.

Trees are nested dicts of tensors, paired leaf for leaf in
``models.common.tree_flatten`` order; ``adamw_update`` and
``clip_by_global_norm`` also take flat lists, which is how the train step
hands them per-layer slices.
"""
from __future__ import annotations

from typing import Any, NamedTuple

import numpy as np
import torch

from repro_torch.config.base import TrainConfig
from repro_torch.models import common

CHUNK = 1 << 26   # elements per in-place piece (256 MB of f32)


class OptState(NamedTuple):
    m: Any
    v: Any
    count: int   # step counter (int32 in the reference)


def init_opt_state(params: Any) -> OptState:
    return OptState(m=common.tree_map(torch.zeros_like, params),
                    v=common.tree_map(torch.zeros_like, params), count=0)


def _leaves(tree: Any) -> list:
    return tree if isinstance(tree, list) else common.tree_flatten(tree)[0]


def _pieces(t: torch.Tensor):
    return t.view(-1).split(CHUNK)


def global_norm(tree: Any) -> torch.Tensor:
    """sqrt of the sum of squares of every leaf, f32 (a device scalar)."""
    sq = [torch.linalg.vector_norm(g, dtype=torch.float32).square() for g in _leaves(tree)]
    return torch.stack(sq).sum().sqrt()


def clip_by_global_norm(grads: Any, max_norm: float):
    """Scale ``grads`` in place so their global norm is at most
    ``max_norm``; returns (grads, the norm before clipping)."""
    norm = global_norm(grads)
    scale = torch.clamp(max_norm / torch.clamp(norm, min=1e-9), max=1.0)
    for g in _leaves(grads):
        g.mul_(scale.to(g.dtype))
    return grads, norm


def adamw_update(grads: Any, state: OptState, params: Any, lr: float, tc: TrainConfig):
    """One AdamW step: ``params``, ``state.m`` and ``state.v`` change in
    place (their leaves must be contiguous); returns (params, OptState with
    the count advanced)."""
    count = state.count + 1
    b1, b2 = tc.beta1, tc.beta2
    bc1 = float(np.float32(1.0) - np.float32(b1) ** np.float32(count))
    bc2 = float(np.float32(1.0) - np.float32(b2) ** np.float32(count))
    with torch.no_grad():
        for p, g, m, v in zip(_leaves(params), _leaves(grads), _leaves(state.m),
                              _leaves(state.v), strict=True):
            for pp, gg, mm, vv in zip(_pieces(p), _pieces(g), _pieces(m), _pieces(v)):
                g32 = gg.float()
                mm.mul_(b1).add_(g32, alpha=1 - b1)
                vv.mul_(b2).addcmul_(g32, g32, value=1 - b2)
                denom = (vv / bc2).sqrt_().add_(tc.eps)
                step = (mm / bc1).div_(denom)
                step.add_(pp.float(), alpha=tc.weight_decay).mul_(lr)
                pp.copy_(pp.float() - step)
    return params, OptState(m=state.m, v=state.v, count=count)
