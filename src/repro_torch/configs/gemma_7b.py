"""gemma-7b [dense] — 28L d_model=3072 16H (GQA kv=16) d_ff=24576
vocab=256000, GeGLU, head_dim=256. [arXiv:2403.08295; hf]
"""
from repro_torch.config import ModelConfig, register_arch

CONFIG = register_arch(
    ModelConfig(
        name="gemma-7b",
        family="dense",
        num_layers=28,
        d_model=3072,
        num_heads=16,
        num_kv_heads=16,
        head_dim=256,
        d_ff=24576,
        vocab_size=256000,
        mlp_activation="gelu",   # GeGLU
        tie_embeddings=True,     # gemma ties the LM head to the embedding
        embed_scale=True,        # gemma multiplies embeddings by sqrt(d_model)
    )
)
