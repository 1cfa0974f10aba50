"""qwen1.5-32b [dense] — 64L d_model=5120 40H (GQA kv=40) d_ff=27392
vocab=152064, QKV bias. [hf:Qwen/Qwen1.5-0.5B; hf]
"""
from repro_torch.config import ModelConfig, register_arch

CONFIG = register_arch(
    ModelConfig(
        name="qwen1.5-32b",
        family="dense",
        num_layers=64,
        d_model=5120,
        num_heads=40,
        num_kv_heads=40,
        d_ff=27392,
        vocab_size=152064,
        qkv_bias=True,
        rope_theta=1_000_000.0,
    )
)
