"""Public model API of the port: ``build_model(cfg)`` -> ``Model``."""
from __future__ import annotations

import dataclasses
from typing import Any, Dict, Optional, Tuple

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
        ``dtype`` stores weight matrices in that type (serving); the leaves
        the model reads in f32 (norm scales, biases, the Mamba block's
        ``x_proj``, ``dt_proj``, ``A_log``, the xLSTM blocks' ``w_if``,
        ``w_gates``, ``r_gates``) stay f32."""
        return common.init_params(self.specs, generator, resolve_device(device), dtype)

    def forward(self, params, batch, opts: Optional[RunOpts] = None):
        return transformer.forward_train(params, batch, self.cfg, opts or RunOpts())

    def forward_hidden(self, params, batch, opts: Optional[RunOpts] = None):
        return transformer.forward_hidden(params, batch, self.cfg, opts or RunOpts())

    def unembed_weight(self, params):
        return transformer.unembed_weight(params, self.cfg)

    def prefill(self, params, batch, cache_seq_len: int, opts: Optional[RunOpts] = None):
        return transformer.prefill(params, batch, self.cfg, opts or RunOpts(), cache_seq_len)

    def decode_step(self, params, cache, tokens, pos: int, opts: Optional[RunOpts] = None):
        return transformer.decode_step(params, cache, tokens, pos, self.cfg, opts or RunOpts())

    def cache_specs(self, batch: int, seq_len: int, int8: bool = False):
        return transformer.cache_specs(self.cfg, batch, seq_len, int8=int8)

    def init_cache(self, batch: int, seq_len: int, device="cuda", int8: bool = False):
        return transformer.init_cache(self.cfg, batch, seq_len, resolve_device(device), int8)

    def decode_step_paged(
        self, params, cache, tokens, seq_lens, block_table, opts: Optional[RunOpts] = None,
    ):
        return transformer.decode_step_paged(
            params, cache, tokens, seq_lens, block_table, self.cfg, opts or RunOpts(),
        )

    def paged_cache_specs(self, num_pages: int, page_size: int = 16, int8: bool = False):
        return transformer.paged_cache_specs(self.cfg, num_pages, page_size, int8=int8)

    def init_paged_cache(self, num_pages: int, device="cuda", page_size: int = 16,
                         int8: bool = False):
        return transformer.init_paged_cache(
            self.cfg, num_pages, resolve_device(device), page_size, int8=int8
        )

    def param_count(self) -> int:
        return sum(int(np.prod(s.shape)) for s in common.tree_leaves(self.specs))


def build_model(cfg: ModelConfig) -> Model:
    return Model(cfg=cfg, specs=transformer.model_specs(cfg))


def input_specs(cfg: ModelConfig, batch: int, seq_len: int,
                mode: str = "train") -> Dict[str, Tuple[Tuple[int, ...], torch.dtype]]:
    """The model's inputs for one cell, as (shape, dtype) by name, as the
    reference's ``input_specs`` gives them: ``tokens`` (B, S) and, in
    training, ``labels`` (``mode="train"``; ``"prefill"`` tokens only;
    ``"decode"`` one token a row), an encoder-decoder's ``frames`` (B,
    encoder_seq_len, d_model) and, but in decode, a VLM's ``patches`` (B,
    vision_tokens, vision_width), both in the compute dtype (the stub
    frontends' precomputed embeddings)."""
    if mode not in ("train", "prefill", "decode"):
        raise ValueError(f"input_specs: mode {mode!r}")
    ct = common.torch_dtype(cfg.dtype)
    out = {"tokens": ((batch, 1 if mode == "decode" else seq_len), torch.int32)}
    if mode == "train":
        out["labels"] = ((batch, seq_len), torch.int32)
    if cfg.encoder_layers:
        out["frames"] = ((batch, cfg.encoder_seq_len, cfg.d_model), ct)
    if cfg.vision_tokens and mode != "decode":
        out["patches"] = ((batch, cfg.vision_tokens, cfg.vision_width), ct)
    return out
