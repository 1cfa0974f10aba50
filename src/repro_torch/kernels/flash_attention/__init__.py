from repro_torch.kernels.flash_attention.ops import flash_attention
from repro_torch.kernels.flash_attention.ref import (
    attention_bwd_ref,
    attention_fwd_ref,
    attention_ref,
)

__all__ = ["flash_attention", "attention_bwd_ref", "attention_fwd_ref", "attention_ref"]
