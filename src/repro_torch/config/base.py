"""Core config dataclasses: the port's own copy of ``repro.config.base``.

Only the pieces the port reads are kept: ``ModelConfig`` (with the family
sub-configs its fields name), ``AttentionKind``, ``BlockKind``,
``ShardingLayout`` and ``TrainConfig``. Field names, defaults and ``reduced()`` are the
reference's, so a config built here compares field for field with the
JAX package's.
"""
from __future__ import annotations

import dataclasses
import enum
from typing import Optional


class AttentionKind(str, enum.Enum):
    FULL = "full"                 # full causal attention
    SLIDING = "sliding"           # sliding-window attention (sub-quadratic)
    NONE = "none"                 # no attention (pure recurrent arch)


class BlockKind(str, enum.Enum):
    """Which residual-block family a layer stack uses."""

    DENSE = "dense"               # attn + MLP
    MOE = "moe"                   # attn + mixture-of-experts MLP
    MAMBA = "mamba"               # SSM block
    HYBRID_PARALLEL = "hybrid"    # parallel attention + SSM heads (Hymba)
    MLSTM = "mlstm"               # xLSTM matrix-memory block
    SLSTM = "slstm"               # xLSTM scalar-memory block
    ENCDEC = "encdec"             # encoder-decoder transformer (Whisper)


@dataclasses.dataclass(frozen=True)
class MoEConfig:
    num_experts: int
    top_k: int = 2
    capacity_factor: float = 1.25
    router_jitter: float = 0.0
    aux_loss_weight: float = 0.01


@dataclasses.dataclass(frozen=True)
class SSMConfig:
    state_dim: int = 16           # N: per-channel state size
    conv_width: int = 4           # depthwise conv width in the Mamba block
    expand: int = 2               # inner dim = expand * d_model
    dt_rank: int = 0              # 0 -> ceil(d_model / 16)
    chunk: int = 128              # chunk length for the chunked scan kernel


@dataclasses.dataclass(frozen=True)
class ModelConfig:
    name: str
    family: str                   # dense | moe | audio | hybrid | ssm | vlm
    num_layers: int
    d_model: int
    num_heads: int
    num_kv_heads: int
    d_ff: int
    vocab_size: int
    head_dim: int = 0             # 0 -> d_model // num_heads
    attention: AttentionKind = AttentionKind.FULL
    window: int = 0               # sliding-window size when attention == SLIDING
    block: BlockKind = BlockKind.DENSE
    qkv_bias: bool = False
    qk_norm: bool = False
    gated_mlp: bool = True        # SwiGLU/GeGLU two-matrix up-projection
    mlp_activation: str = "silu"  # silu (SwiGLU) | gelu (GeGLU)
    tie_embeddings: bool = False
    embed_scale: bool = False     # multiply embeddings by sqrt(d_model) (gemma)
    rope_theta: float = 10_000.0
    norm_eps: float = 1e-6
    moe: Optional[MoEConfig] = None
    ssm: Optional[SSMConfig] = None
    encoder_layers: int = 0
    encoder_seq_len: int = 0
    slstm_every: int = 0
    vision_tokens: int = 0
    vision_width: int = 0
    # numerics
    dtype: str = "bfloat16"
    param_dtype: str = "float32"

    @property
    def resolved_head_dim(self) -> int:
        return self.head_dim if self.head_dim else self.d_model // self.num_heads

    @property
    def q_dim(self) -> int:
        return self.num_heads * self.resolved_head_dim

    @property
    def kv_dim(self) -> int:
        return self.num_kv_heads * self.resolved_head_dim

    def reduced(self) -> "ModelConfig":
        """Family-preserving tiny config for CPU tests (the reference's)."""
        kw = dict(
            name=self.name + "-reduced",
            num_layers=min(self.num_layers, 2),
            d_model=128,
            num_heads=4,
            num_kv_heads=min(self.num_kv_heads, 4) if self.num_kv_heads < self.num_heads else 4,
            head_dim=32,
            d_ff=256 if self.d_ff else 0,
            vocab_size=256,
            encoder_layers=min(self.encoder_layers, 2),
            encoder_seq_len=16 if self.encoder_seq_len else 0,
            vision_tokens=8 if self.vision_tokens else 0,
            vision_width=64 if self.vision_width else 0,
        )
        if self.slstm_every:
            kw["slstm_every"] = 2
            kw["num_layers"] = 4
        if self.moe is not None:
            kw["moe"] = dataclasses.replace(self.moe, num_experts=min(self.moe.num_experts, 4))
        if self.ssm is not None:
            kw["ssm"] = dataclasses.replace(self.ssm, state_dim=8, chunk=8)
        # keep GQA structure: kv strictly divides q heads
        if self.num_kv_heads < self.num_heads:
            kw["num_kv_heads"] = 2
        if self.window:
            kw["window"] = 8
        return dataclasses.replace(self, **kw)


@dataclasses.dataclass(frozen=True)
class ShardingLayout:
    """Named layout preset. The port reads ``attn_impl``, ``q_chunk``,
    ``kv_chunk``, ``int8_kv_cache``, ``fused_ce``, ``ce_chunk``,
    ``gradient_allreduce_dtype`` and ``remat``; the other fields are the
    reference's mesh and scan knobs, kept so a layout compares field for
    field."""

    name: str = "baseline"
    param_rules: str = "baseline"
    opt_rules: str = ""
    sequence_shard_activations: bool = True
    attn_gather_kv: bool = False
    fused_ce: bool = True
    ce_chunk: int = 256
    gradient_allreduce_dtype: str = "float32"
    remat: str = "full"
    scan_layers: bool = True
    attn_impl: str = "masked"         # masked | flash
    q_chunk: int = 512
    kv_chunk: int = 1024
    decode_unroll: bool = False
    int8_kv_cache: bool = False


@dataclasses.dataclass(frozen=True)
class TrainConfig:
    learning_rate: float = 3e-4
    weight_decay: float = 0.1
    beta1: float = 0.9
    beta2: float = 0.95
    eps: float = 1e-8
    grad_clip: float = 1.0
    warmup_steps: int = 100
    total_steps: int = 1000
    microbatches: int = 1             # gradient accumulation factor
    seed: int = 0
    label_smoothing: float = 0.0
