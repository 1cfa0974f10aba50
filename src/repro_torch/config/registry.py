"""Architecture and input-shape registry: ``repro_torch.configs`` modules
register at import; the four assigned LM shapes are the reference's."""
from __future__ import annotations

import importlib
import pkgutil
from typing import Dict, List, Tuple

from repro_torch.config.base import InputShape, ModelConfig

_ARCHS: Dict[str, ModelConfig] = {}

SHAPES: Dict[str, InputShape] = {
    "train_4k": InputShape("train_4k", seq_len=4_096, global_batch=256, mode="train"),
    "prefill_32k": InputShape("prefill_32k", seq_len=32_768, global_batch=32, mode="prefill"),
    "decode_32k": InputShape("decode_32k", seq_len=32_768, global_batch=128, mode="decode"),
    "long_500k": InputShape("long_500k", seq_len=524_288, global_batch=1, mode="decode"),
}


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


def get_shape(name: str) -> InputShape:
    return SHAPES[name]


def list_shapes() -> List[str]:
    return list(SHAPES)


def runnable_cells() -> List[Tuple[str, str]]:
    """All (arch, shape) pairs but long_500k on an arch without
    sub-quadratic decode state, as the reference skips it."""
    _ensure_loaded()
    cells: List[Tuple[str, str]] = []
    for arch in sorted(_ARCHS):
        cfg = _ARCHS[arch]
        for shape in SHAPES.values():
            if shape.name == "long_500k" and not cfg.sub_quadratic:
                continue
            cells.append((arch, shape.name))
    return cells
