"""qwen1.5-4b [dense] — 40L d_model=2560 20H (GQA kv=20) d_ff=6912
vocab=151936, QKV bias. [hf:Qwen/Qwen1.5-0.5B; hf]
"""
from repro_torch.config import ModelConfig, register_arch

CONFIG = register_arch(
    ModelConfig(
        name="qwen1.5-4b",
        family="dense",
        num_layers=40,
        d_model=2560,
        num_heads=20,
        num_kv_heads=20,
        d_ff=6912,
        vocab_size=151936,
        qkv_bias=True,
    )
)
