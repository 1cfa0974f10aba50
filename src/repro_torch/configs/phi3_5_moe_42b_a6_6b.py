"""phi3.5-moe-42b-a6.6b [moe] — 32L d_model=4096 32H (GQA kv=8) d_ff=6400
vocab=32064, MoE 16 experts top-2. [hf:microsoft/Phi-3.5-MoE-instruct; hf]
"""
from repro_torch.config import BlockKind, ModelConfig, MoEConfig, register_arch

CONFIG = register_arch(
    ModelConfig(
        name="phi3.5-moe-42b-a6.6b",
        family="moe",
        num_layers=32,
        d_model=4096,
        num_heads=32,
        num_kv_heads=8,
        d_ff=6400,
        vocab_size=32064,
        block=BlockKind.MOE,
        moe=MoEConfig(num_experts=16, top_k=2),
    )
)
