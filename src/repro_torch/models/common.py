"""Parameter-spec machinery shared by the model code (port of
``repro.models.common``).

A model is a spec tree (``ParamSpec`` leaves: shape, logical axes, init
recipe) plus plain functions over a matching tree of tensors. Stacked
parameters carry a leading ``"layers"`` axis exactly as in the reference,
so a JAX param tree converts leaf for leaf (``models/convert.py``) and
the layer loop indexes ``blocks[...][i]``, a view.
"""
from __future__ import annotations

import dataclasses
from typing import Any, Callable, Optional, Tuple

import numpy as np
import torch

LOGICAL_AXES = (
    "layers",      # scan dim — never sharded
    "groups",      # xLSTM super-block scan dim — never sharded
    "vocab",       # embedding / lm-head vocab dim
    "embed",       # d_model (a.k.a. residual stream)
    "q_dim",       # fused num_heads * head_dim projection output
    "kv_dim",      # fused num_kv_heads * head_dim projection output
    "heads",       # attention heads (activations)
    "kv_heads",
    "head_dim",
    "ffn",         # MLP hidden
    "experts",     # MoE expert dim
    "ssm_inner",   # Mamba inner (expand * d_model)
    "ssm_state",   # Mamba state N
    "conv",        # depthwise conv width
    "dt_rank",
    "enc_embed",   # encoder width (enc-dec models)
    "vit_embed",   # stub vision encoder width (VLM)
    "seq",         # sequence dim (activations only)
    "batch",       # batch dim (activations only)
)

# stacking dims: every slot holds every layer, so ``repro_torch.dist`` never
# maps these to a mesh axis
SCAN_AXES = ("layers", "groups")

_DTYPES = {"float32": torch.float32, "bfloat16": torch.bfloat16, "int32": torch.int32,
           "int8": torch.int8}


def torch_dtype(name) -> torch.dtype:
    """Config dtype name (``"bfloat16"``) -> ``torch.dtype``."""
    if isinstance(name, torch.dtype):
        return name
    return _DTYPES[name]


@dataclasses.dataclass(frozen=True)
class ParamSpec:
    shape: Tuple[int, ...]
    axes: Tuple[Optional[str], ...]
    init: str = "normal"          # normal | zeros | ones | embed
    scale: float = 1.0            # multiplier on the init std
    dtype: str = "float32"
    keep_f32: bool = False        # the model reads it in f32 (not in the reference's spec)

    def __post_init__(self):
        assert len(self.shape) == len(self.axes), (self.shape, self.axes)

    @property
    def is_matrix(self) -> bool:
        """A weight matrix that the model casts to the compute dtype at each
        use, so serving may store it in that dtype: two or more non-stacking
        axes, and not ``keep_f32`` (the Mamba block's ``x_proj``, ``dt_proj``
        and ``A_log``, the xLSTM blocks' ``w_if``, ``w_gates`` and
        ``r_gates`` feed f32 arithmetic). Norm scales and biases are not."""
        return not self.keep_f32 and sum(a not in SCAN_AXES for a in self.axes) >= 2


def tree_map(fn: Callable, tree: Any) -> Any:
    """Map over the leaves of a tree of nested dicts and lists (specs or
    tensors)."""
    if isinstance(tree, dict):
        return {k: tree_map(fn, v) for k, v in tree.items()}
    if isinstance(tree, list):
        return [tree_map(fn, v) for v in tree]
    return fn(tree)


def tree_leaves(tree: Any) -> list:
    if isinstance(tree, dict):
        return [leaf for v in tree.values() for leaf in tree_leaves(v)]
    return [tree]


def tree_flatten(tree: Any) -> Tuple[list, Callable[[list], Any]]:
    """(leaves in the reference's ``jax.tree_util`` order, a function that
    rebuilds the tree from such a leaf list). Dicts flatten by sorted key
    and rebuild in their own key order; tuples (named or not) and lists
    flatten in order; everything else is a leaf."""
    if isinstance(tree, dict):
        keys = sorted(tree)
        parts = [tree_flatten(tree[k]) for k in keys]
    elif isinstance(tree, (tuple, list)):
        keys = None
        parts = [tree_flatten(t) for t in tree]
    else:
        return [tree], lambda leaves: leaves[0]
    sizes = [len(leaves) for leaves, _ in parts]

    def unflatten(leaves: list) -> Any:
        out, i = [], 0
        for (_, rebuild), n in zip(parts, sizes):
            out.append(rebuild(leaves[i:i + n]))
            i += n
        if keys is not None:
            by_key = dict(zip(keys, out))
            return {k: by_key[k] for k in tree}
        if hasattr(tree, "_fields"):
            return type(tree)(*out)
        return type(tree)(out)

    return [leaf for leaves, _ in parts for leaf in leaves], unflatten


def stacked(tree: Any, n: int, axis_name: str = "layers") -> Any:
    """Prepend a stacking dim to every spec of ``tree``."""
    return tree_map(
        lambda s: dataclasses.replace(s, shape=(n,) + s.shape, axes=(axis_name,) + s.axes),
        tree,
    )


def param_bytes(specs: Any) -> int:
    return sum(
        int(np.prod(s.shape)) * torch.empty((), dtype=torch_dtype(s.dtype)).element_size()
        for s in tree_leaves(specs)
    )


# a leaf with more elements than this is drawn one slice of its leading
# (stacking) dim at a time, so that its f32 draw never sits beside the whole
# leaf: one (16, 8, 4096, 14336) expert leaf is 30 GB in f32. Every smaller
# leaf is drawn at once, as before.
DRAW_BY_SLICE_NUMEL = 2**31


def _init_one(spec: ParamSpec, generator: torch.Generator, device, dtype) -> torch.Tensor:
    out_dtype = torch_dtype(dtype) if (dtype is not None and spec.is_matrix) \
        else torch_dtype(spec.dtype)
    if spec.init == "zeros":
        return torch.zeros(spec.shape, dtype=out_dtype, device=device)
    if spec.init == "ones":
        return torch.ones(spec.shape, dtype=out_dtype, device=device)
    if spec.init == "embed":
        std = spec.scale
    else:  # fan-in scaled normal
        fan_in = spec.shape[-2] if len(spec.shape) >= 2 else spec.shape[-1]
        std = spec.scale / np.sqrt(max(fan_in, 1))
    if int(np.prod(spec.shape)) <= DRAW_BY_SLICE_NUMEL:
        x = torch.randn(spec.shape, generator=generator, device=device, dtype=torch.float32)
        return x.mul_(float(std)).to(out_dtype)
    out = torch.empty(spec.shape, dtype=out_dtype, device=device)
    for i in range(spec.shape[0]):
        x = torch.randn(spec.shape[1:], generator=generator, device=device, dtype=torch.float32)
        out[i] = x.mul_(float(std))
    return out


def init_params(specs: Any, generator: torch.Generator, device, dtype=None) -> Any:
    """Materialize a spec tree with the reference's recipes (fan-in-scaled
    normal, ``embed``, ``ones``, ``zeros``), drawing from ``generator`` in
    leaf order. The numbers differ from ``jax.random``'s by design.
    ``dtype`` (e.g. ``torch.bfloat16``) stores weight matrices
    (``ParamSpec.is_matrix``) in that type; the other leaves keep their
    spec dtype (f32)."""
    return tree_map(lambda s: _init_one(s, generator, device, dtype), specs)


def dense(x: torch.Tensor, w: torch.Tensor, compute_dtype) -> torch.Tensor:
    """y = x @ w with both operands in the compute dtype."""
    ct = torch_dtype(compute_dtype)
    return torch.matmul(x.to(ct), w.to(ct))
