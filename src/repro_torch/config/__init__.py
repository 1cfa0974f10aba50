"""Typed configuration for the PyTorch port (a copy, not an import, of
``repro.config``: the port runs where the JAX package is not installed)."""
from repro_torch.config.base import (
    AttentionKind,
    BlockKind,
    InputShape,
    ModelConfig,
    MoEConfig,
    ShardingLayout,
    SSMConfig,
    TrainConfig,
)
from repro_torch.config.registry import (
    SHAPES,
    get_arch,
    get_shape,
    list_archs,
    list_shapes,
    register_arch,
    runnable_cells,
)

__all__ = [
    "AttentionKind",
    "BlockKind",
    "InputShape",
    "ModelConfig",
    "MoEConfig",
    "SSMConfig",
    "ShardingLayout",
    "TrainConfig",
    "SHAPES",
    "get_arch",
    "get_shape",
    "list_archs",
    "list_shapes",
    "register_arch",
    "runnable_cells",
]
