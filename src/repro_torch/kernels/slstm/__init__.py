from repro_torch.kernels.slstm.ops import slstm
from repro_torch.kernels.slstm.ref import slstm_bwd_ref, slstm_ref

__all__ = ["slstm", "slstm_bwd_ref", "slstm_ref"]
