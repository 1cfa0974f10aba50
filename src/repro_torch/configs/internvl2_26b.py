"""internvl2-26b [vlm] — 48L d_model=6144 48H (GQA kv=8) d_ff=16384
vocab=92553 (InternLM2-20B backbone); InternViT frontend is a STUB
(input_specs provides precomputed patch embeddings). [arXiv:2404.16821; hf]
"""
from repro_torch.config import ModelConfig, register_arch

CONFIG = register_arch(
    ModelConfig(
        name="internvl2-26b",
        family="vlm",
        num_layers=48,
        d_model=6144,
        num_heads=48,
        num_kv_heads=8,
        d_ff=16384,
        vocab_size=92553,
        vision_tokens=1025,      # 448px / 14 patch -> 1024 + cls, pixel-shuffled stub
        vision_width=3200,       # InternViT-6B width
    )
)
