"""Public model API of the port: ``build_model(cfg)`` -> ``Model``."""
from __future__ import annotations

import dataclasses
from typing import Any, Dict, Optional

import numpy as np
import torch

from repro_torch import resolve_device
from repro_torch.config.base import ModelConfig
from repro_torch.models import common, transformer
from repro_torch.models.transformer import RunOpts


@dataclasses.dataclass(frozen=True)
class Model:
    """A built architecture: specs plus the driver functions."""

    cfg: ModelConfig
    specs: Dict[str, Any]

    def init(self, generator: torch.Generator, device="cuda", dtype=None) -> Any:
        """Random params from ``generator`` (which must live on ``device``).
        ``dtype`` stores weight matrices in that type (serving); norm
        scales stay f32."""
        return common.init_params(self.specs, generator, resolve_device(device), dtype)

    def forward(self, params, batch, opts: Optional[RunOpts] = None):
        return transformer.forward_train(params, batch, self.cfg, opts or RunOpts())

    def forward_hidden(self, params, batch, opts: Optional[RunOpts] = None):
        return transformer.forward_hidden(params, batch, self.cfg, opts or RunOpts())

    def unembed_weight(self, params):
        return transformer.unembed_weight(params, self.cfg)

    def prefill(self, params, batch, cache_seq_len: int, opts: Optional[RunOpts] = None):
        return transformer.prefill(params, batch, self.cfg, opts or RunOpts(), cache_seq_len)

    def decode_step_paged(
        self, params, cache, tokens, seq_lens, block_table, opts: Optional[RunOpts] = None,
    ):
        return transformer.decode_step_paged(
            params, cache, tokens, seq_lens, block_table, self.cfg, opts or RunOpts(),
        )

    def paged_cache_specs(self, num_pages: int, page_size: int = 16):
        return transformer.paged_cache_specs(self.cfg, num_pages, page_size)

    def init_paged_cache(self, num_pages: int, device="cuda", page_size: int = 16):
        return transformer.init_paged_cache(
            self.cfg, num_pages, resolve_device(device), page_size
        )

    def param_count(self) -> int:
        return sum(int(np.prod(s.shape)) for s in common.tree_leaves(self.specs))


def build_model(cfg: ModelConfig) -> Model:
    return Model(cfg=cfg, specs=transformer.model_specs(cfg))
