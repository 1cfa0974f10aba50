from repro_torch.kernels.mlstm.ops import mlstm
from repro_torch.kernels.mlstm.ref import (mlstm_chunkwise_bwd_ref, mlstm_chunkwise_hilo_ref,
                                          mlstm_chunkwise_ref, mlstm_chunkwise_split_ref,
                                          mlstm_ref, mlstm_step_ref)

__all__ = ["mlstm", "mlstm_chunkwise_bwd_ref", "mlstm_chunkwise_hilo_ref", "mlstm_chunkwise_ref",
           "mlstm_chunkwise_split_ref", "mlstm_ref", "mlstm_step_ref"]
