"""hymba-1.5b [hybrid] — 32L d_model=1600 25H (GQA kv=5) d_ff=5504
vocab=32001, ssm_state=16, parallel attention + mamba heads, sliding-window
attention (global attn only on a few layers in the paper; we use SWA so the
arch is sub-quadratic, per its long-context design). [arXiv:2411.13676; hf]
"""
from repro_torch.config import AttentionKind, BlockKind, ModelConfig, SSMConfig, register_arch

CONFIG = register_arch(
    ModelConfig(
        name="hymba-1.5b",
        family="hybrid",
        num_layers=32,
        d_model=1600,
        num_heads=25,
        num_kv_heads=5,
        d_ff=5504,
        vocab_size=32001,
        block=BlockKind.HYBRID_PARALLEL,
        attention=AttentionKind.SLIDING,
        window=1024,
        ssm=SSMConfig(state_dim=16, expand=2),
    )
)
