"""mixtral-8x7b [moe] — 32L d_model=4096 32H (GQA kv=8) d_ff=14336
vocab=32000, MoE 8 experts top-2, sliding-window attention. [arXiv:2401.04088; hf]
"""
from repro_torch.config import AttentionKind, BlockKind, ModelConfig, MoEConfig, register_arch

CONFIG = register_arch(
    ModelConfig(
        name="mixtral-8x7b",
        family="moe",
        num_layers=32,
        d_model=4096,
        num_heads=32,
        num_kv_heads=8,
        d_ff=14336,
        vocab_size=32000,
        block=BlockKind.MOE,
        attention=AttentionKind.SLIDING,
        window=4096,
        moe=MoEConfig(num_experts=8, top_k=2),
    )
)
