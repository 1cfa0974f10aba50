"""Serve-step builders (port of the serving half of ``repro.train.steps``).

Training steps come with a later slice. Without ``jit`` a builder just
binds the model, layout and static arguments into a plain function.
"""
from __future__ import annotations

from repro_torch.config.base import ShardingLayout
from repro_torch.models import zoo
from repro_torch.models.transformer import RunOpts


def run_opts_from_layout(layout: ShardingLayout) -> RunOpts:
    return RunOpts(
        attn_impl=layout.attn_impl,
        q_chunk=layout.q_chunk,
        kv_chunk=layout.kv_chunk,
        int8_kv_cache=layout.int8_kv_cache,
    )


def build_prefill_step(model: zoo.Model, layout: ShardingLayout, cache_seq_len: int):
    opts = run_opts_from_layout(layout)

    def prefill_step(params, batch):
        return model.prefill(params, batch, cache_seq_len, opts)

    return prefill_step


def build_paged_decode_step(model: zoo.Model, layout: ShardingLayout):
    """(params, cache, tokens (B,1), seq_lens (B,), block_table (B,nb))
    -> (logits, cache); the pool is updated in place."""
    opts = run_opts_from_layout(layout)

    def paged_decode_step(params, cache, tokens, seq_lens, block_table):
        return model.decode_step_paged(params, cache, tokens, seq_lens, block_table, opts)

    return paged_decode_step
