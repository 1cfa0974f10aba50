"""Carry parameters between the JAX package and the port through numpy.

The JAX package's param tree is nested dicts with a stacked leading
``layers`` axis (``repro.models.common.stacked``); the port keeps the same
tree, so conversion is leaf for leaf. The caller turns JAX arrays into
numpy first (``jax.tree_util.tree_map(np.asarray, params)``): this module
imports neither JAX nor ``repro``.
"""
from __future__ import annotations

from typing import Any, Optional

import numpy as np
import torch

from repro_torch import resolve_device
from repro_torch.config.base import ModelConfig
from repro_torch.models import common, transformer


def _zip_specs(fn, specs: Any, tree: Any) -> Any:
    if isinstance(specs, dict):
        if set(specs) != set(tree):
            raise KeyError(f"param tree keys {sorted(tree)} != specs {sorted(specs)}")
        return {k: _zip_specs(fn, specs[k], tree[k]) for k in specs}
    return fn(specs, tree)


def params_from_jax(tree: Any, cfg: ModelConfig, device, dtype: Optional[torch.dtype] = None):
    """numpy param tree (JAX layout) -> the port's tensors on ``device``.

    ``dtype`` stores weight matrices in that type (``torch.bfloat16`` for
    serving: one cast now gives the bits the JAX path's per-call cast
    gives); norm scales always stay f32, as the reference reads them.
    """
    dev = resolve_device(device)

    def one(spec, arr):
        arr = np.asarray(arr)
        if tuple(arr.shape) != tuple(spec.shape):
            raise ValueError(f"shape {arr.shape} != spec {spec.shape}")
        t = torch.from_numpy(np.array(arr, copy=True)).to(dev)
        return t.to(dtype) if (dtype is not None and spec.is_matrix) else t

    return _zip_specs(one, transformer.model_specs(cfg), tree)


def params_to_numpy(params: Any) -> Any:
    """The port's params -> numpy tree in the JAX layout (f32 leaves stay
    bit-exact, so ``params_to_numpy(params_from_jax(t))`` equals ``t``)."""
    return common.tree_map(lambda t: t.detach().cpu().float().numpy(), params)
