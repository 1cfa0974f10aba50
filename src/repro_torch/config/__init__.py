"""Typed configuration for the PyTorch port (a copy, not an import, of
``repro.config``: the port runs where the JAX package is not installed)."""
from repro_torch.config.base import (
    AttentionKind,
    BlockKind,
    ModelConfig,
    MoEConfig,
    ShardingLayout,
    SSMConfig,
)
from repro_torch.config.registry import get_arch, register_arch

__all__ = [
    "AttentionKind",
    "BlockKind",
    "ModelConfig",
    "MoEConfig",
    "SSMConfig",
    "ShardingLayout",
    "get_arch",
    "register_arch",
]
