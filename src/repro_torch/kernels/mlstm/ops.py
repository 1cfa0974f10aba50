"""Public chunkwise-mLSTM entry point, in the model's layout.

Dispatch is by the tensor's device: a CUDA tensor launches the kernel (or
raises), a CPU tensor runs the plain ``mlstm_chunkwise_ref`` at the
model's ``chunk``. On the card the gates and the state go to the kernels
in f32 and contiguous; q/k/v keep their dtype (f32 or bf16), which is h's,
and may be strided views of the (B, S, inner) projections. ``kernel.mlstm``
picks the kernel (a decode step of a few timesteps: one pass over C;
longer: the chunkwise kernel, on tensor cores in bf16, and as split TF32
on the tensor cores for f32 and the rest); each bounds its loops by S, so nothing is padded: the stabilizer
and the state are the same for any chunk length, up to rounding.
"""
from __future__ import annotations

from typing import Optional, Tuple

import torch

from repro_torch.kernels.mlstm import kernel
from repro_torch.kernels.mlstm.ref import mlstm_chunkwise_ref


def mlstm(
    q: torch.Tensor,       # (B, S, H, hd)
    k: torch.Tensor,
    v: torch.Tensor,
    gates: torch.Tensor,   # (B, S, 2H)
    state: Optional[Tuple[torch.Tensor, torch.Tensor, torch.Tensor]] = None,
    chunk: int = 64,
) -> Tuple[torch.Tensor, Tuple[torch.Tensor, torch.Tensor, torch.Tensor]]:
    """Returns (h (B,S,H,hd) in q's dtype, (C (B,H,hd,hd), n (B,H,hd), m (B,H)) f32)."""
    if q.device.type == "cuda":
        f32 = lambda t: t.float().contiguous()
        return kernel.mlstm(q, k, v, f32(gates),
                            None if state is None else tuple(f32(t) for t in state))
    if q.device.type == "cpu":
        return mlstm_chunkwise_ref(q, k, v, gates, state, chunk)
    raise ValueError(f"mlstm: unsupported device {q.device}")
