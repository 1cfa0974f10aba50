"""Carry parameters, dense caches and train states between the JAX package
and the port through numpy.

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
from repro_torch.optim import OptState
from repro_torch.train.steps import TrainState


def _zip_specs(fn, specs: Any, tree: Any) -> Any:
    if isinstance(specs, dict):
        if set(specs) != set(tree):
            raise KeyError(f"param tree keys {sorted(tree)} != specs {sorted(specs)}")
        return {k: _zip_specs(fn, specs[k], tree[k]) for k in specs}
    return fn(specs, tree)


def params_from_jax(tree: Any, cfg: ModelConfig, device, dtype: Optional[torch.dtype] = None):
    """numpy param tree (JAX layout) -> the port's tensors on ``device``.

    ``dtype`` stores the weight matrices that the model casts to the
    compute dtype at each use (``ParamSpec.is_matrix``) in that type
    (``torch.bfloat16`` for serving: one cast now gives the bits the JAX
    path's per-call cast gives). Every other leaf stays f32, as the
    reference reads it: norm scales, biases, the Mamba block's
    ``x_proj``, ``dt_proj`` and ``A_log``, and the xLSTM blocks' ``w_if``,
    ``w_gates`` and ``r_gates``.
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
    bit-exact, so ``params_to_numpy(params_from_jax(t))`` equals ``t``).
    The arrays are copies: the train step updates params in place."""
    return common.tree_map(lambda t: np.array(t.detach().cpu().float().numpy()), params)


def cache_from_jax(tree: Any, cfg: ModelConfig, batch: int, seq_len: int, device):
    """numpy cache (JAX layout, from ``Model.prefill`` or
    ``Model.init_cache``; the hybrid block's state nested under ``ssm``, the
    xLSTM states under ``groups``) ->
    the port's tensors on ``device``, each in the dtype it arrives in (a
    JAX bf16 leaf goes through f32, losslessly); shapes are checked against
    ``cache_specs(cfg, batch, seq_len)``."""
    dev = resolve_device(device)

    def one(spec, arr):
        arr = np.asarray(arr)
        if tuple(arr.shape) != tuple(spec.shape):
            raise ValueError(f"shape {arr.shape} != spec {spec.shape}")
        if arr.dtype.name == "bfloat16":
            return torch.from_numpy(arr.astype(np.float32)).to(dev, torch.bfloat16)
        return torch.from_numpy(np.array(arr, copy=True)).to(dev)

    return _zip_specs(one, transformer.cache_specs(cfg, batch, seq_len), tree)


def cache_to_numpy(cache: Any) -> Any:
    """The port's cache -> numpy tree in the JAX layout: int leaves
    (``pos_ids``) as int32, float leaves as f32 (bf16 ones exactly). The
    arrays are copies: decode updates the cache in place."""
    def one(t):
        t = t.detach().cpu()
        return np.array(t.numpy() if not t.is_floating_point() else t.float().numpy())

    return common.tree_map(one, cache)


def train_state_from_jax(state: Any, cfg: ModelConfig, device):
    """A JAX ``TrainState`` whose arrays are numpy (``jax.tree_util.tree_map(
    np.asarray, state)``) -> the port's ``TrainState`` on ``device``:
    params, ``m`` and ``v`` leaf for leaf (f32, bit-exact), ``count`` and
    ``step`` as ints."""
    return TrainState(
        params=params_from_jax(state.params, cfg, device),
        opt=OptState(
            m=params_from_jax(state.opt.m, cfg, device),
            v=params_from_jax(state.opt.v, cfg, device),
            count=int(state.opt.count),
        ),
        step=int(state.step),
    )


def train_state_to_numpy(state: Any):
    """The port's ``TrainState`` -> the same structure with numpy leaves in
    the JAX layout (``count`` and ``step`` as int32 scalars), ready for
    ``repro.train.steps.TrainState(params, OptState(m, v, count), step)``."""
    return TrainState(
        params=params_to_numpy(state.params),
        opt=OptState(
            m=params_to_numpy(state.opt.m),
            v=params_to_numpy(state.opt.v),
            count=np.asarray(state.opt.count, np.int32),
        ),
        step=np.asarray(state.step, np.int32),
    )
