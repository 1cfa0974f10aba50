"""xlstm-350m [ssm] — 24L d_model=1024 4H d_ff=0 vocab=50304,
sLSTM + mLSTM blocks (1 sLSTM every 6 blocks), no separate FFN (the xLSTM
block carries its own up/down projection). [arXiv:2405.04517; unverified]
"""
from repro_torch.config import AttentionKind, BlockKind, ModelConfig, SSMConfig, register_arch

CONFIG = register_arch(
    ModelConfig(
        name="xlstm-350m",
        family="ssm",
        num_layers=24,
        d_model=1024,
        num_heads=4,
        num_kv_heads=4,
        d_ff=0,
        vocab_size=50304,
        block=BlockKind.MLSTM,
        attention=AttentionKind.NONE,
        slstm_every=6,
        ssm=SSMConfig(chunk=256),  # chunkwise-parallel mLSTM chunk length
    )
)
