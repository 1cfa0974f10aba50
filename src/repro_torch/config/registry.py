"""Architecture registry: ``repro_torch.configs`` modules register at import."""
from __future__ import annotations

import importlib
import pkgutil
from typing import Dict

from repro_torch.config.base import ModelConfig

_ARCHS: Dict[str, ModelConfig] = {}


def register_arch(cfg: ModelConfig) -> ModelConfig:
    if cfg.name in _ARCHS and _ARCHS[cfg.name] != cfg:
        raise ValueError(f"conflicting registration for arch {cfg.name!r}")
    _ARCHS[cfg.name] = cfg
    return cfg


def _ensure_loaded() -> None:
    """Import every module under repro_torch.configs exactly once."""
    import repro_torch.configs as pkg

    for mod in pkgutil.iter_modules(pkg.__path__):
        importlib.import_module(f"repro_torch.configs.{mod.name}")


def get_arch(name: str) -> ModelConfig:
    _ensure_loaded()
    try:
        return _ARCHS[name]
    except KeyError:
        raise KeyError(f"unknown arch {name!r}; available: {sorted(_ARCHS)}") from None



def list_archs() -> list:
    _ensure_loaded()
    return sorted(_ARCHS)
