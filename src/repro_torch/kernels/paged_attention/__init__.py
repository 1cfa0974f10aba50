from repro_torch.kernels.paged_attention.ops import (paged_decode_attention,
                                                    paged_decode_attention_int8)
from repro_torch.kernels.paged_attention.ref import (paged_attention_int8_ref,
                                                    paged_attention_ref,
                                                    paged_attention_split_ref)

__all__ = ["paged_decode_attention", "paged_decode_attention_int8", "paged_attention_ref",
           "paged_attention_split_ref", "paged_attention_int8_ref"]
