"""whisper-tiny [audio] — 4L d_model=384 6H (kv=6) d_ff=1536 vocab=51865,
enc-dec; conv frontend is a STUB (input_specs provides precomputed frame
embeddings of shape (B, 1500, 384)). [arXiv:2212.04356; unverified]
"""
from repro_torch.config import BlockKind, ModelConfig, register_arch

CONFIG = register_arch(
    ModelConfig(
        name="whisper-tiny",
        family="audio",
        num_layers=4,
        d_model=384,
        num_heads=6,
        num_kv_heads=6,
        d_ff=1536,
        vocab_size=51865,
        block=BlockKind.ENCDEC,
        encoder_layers=4,
        encoder_seq_len=1500,
        gated_mlp=False,          # whisper uses plain GELU MLP
        mlp_activation="gelu",
        qkv_bias=True,
        tie_embeddings=True,     # whisper ties the decoder embedding
    )
)
