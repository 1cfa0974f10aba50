"""Launch wrapper of the CUDA chunkwise mLSTM (``csrc/mlstm.cu``, replacing
the Pallas ``_mlstm_kernel``).

``mlstm`` validates what the kernel takes, allocates the outputs, launches
on PyTorch's current stream and counts the launch in ``launches``. It
never falls back: anything the kernel does not take raises.
"""
from __future__ import annotations

from typing import Optional, Tuple

import torch

from repro_torch.kernels import _build

launches = 0   # kernel launches since the last reset (plain int)

MAX_HEAD_DIM = 512   # the kernel keeps a 32-row tile of C (32 x hd f32) in shared memory
CHUNK = 32           # timesteps per chunk of the kernel (``L`` in csrc/mlstm.cu)


def _check(q, k, v, gates, state) -> None:
    dev = q.device
    f32 = [gates, *(state or ())]
    if not q.is_cuda or any(t.device != dev for t in (k, v, *f32)):
        raise ValueError("mlstm kernel: all inputs must be on one CUDA device")
    if q.dtype not in _build.DTYPE_CODE or k.dtype != q.dtype or v.dtype != q.dtype:
        raise ValueError(f"mlstm kernel: q/k/v dtype {q.dtype}/{k.dtype}/{v.dtype} "
                         f"(one of float32, bfloat16)")
    if any(t.dtype != torch.float32 for t in f32):
        raise ValueError(f"mlstm kernel: gates and state must be float32, "
                         f"got {[t.dtype for t in f32]}")
    if q.dim() != 4 or k.shape != q.shape or v.shape != q.shape:
        raise ValueError(f"mlstm kernel: q{tuple(q.shape)} k{tuple(k.shape)} v{tuple(v.shape)}"
                         f" are not one (B, S, H, hd)")
    B, S, H, hd = q.shape
    if tuple(gates.shape) != (B, S, 2 * H) or gates.stride(2) != 1:
        raise ValueError(f"mlstm kernel: gates{tuple(gates.shape)}, expected {(B, S, 2 * H)} "
                         f"with a contiguous last dim")
    if hd % 32 or not 32 <= hd <= MAX_HEAD_DIM:
        raise ValueError(f"mlstm kernel: head_dim {hd} (a multiple of 32 up to {MAX_HEAD_DIM})")
    if B * H > 65535:
        raise ValueError(f"mlstm kernel: B*H = {B * H} exceeds the grid's 65535 rows")
    if any(t.stride(3) != 1 for t in (q, k, v)):
        raise ValueError("mlstm kernel: q/k/v rows (head_dim) must be contiguous")
    if state is not None:
        want = ((B, H, hd, hd), (B, H, hd), (B, H))
        for name, t, shape in zip("Cnm", state, want):
            if tuple(t.shape) != shape or not t.is_contiguous():
                raise ValueError(f"mlstm kernel: state {name}{tuple(t.shape)}, expected a "
                                 f"contiguous {shape}")


def mlstm(
    q: torch.Tensor,       # (B, S, H, hd) f32 or bf16, rows contiguous
    k: torch.Tensor,
    v: torch.Tensor,
    gates: torch.Tensor,   # (B, S, 2H) f32: ĩ in [..., :H], f̃ in [..., H:]
    state: Optional[Tuple[torch.Tensor, torch.Tensor, torch.Tensor]] = None,
) -> Tuple[torch.Tensor, Tuple[torch.Tensor, torch.Tensor, torch.Tensor]]:
    """Returns (h (B,S,H,hd) in q's dtype, (C (B,H,hd,hd), n (B,H,hd), m (B,H)) f32).
    ``state`` (C, n, m) f32 contiguous, None for zeros; it is only read."""
    global launches
    _check(q, k, v, gates, state)
    B, S, H, hd = q.shape
    h = torch.empty((B, S, H, hd), dtype=q.dtype, device=q.device)
    C = torch.empty((B, H, hd, hd), dtype=torch.float32, device=q.device)
    n = torch.empty((B, H, hd), dtype=torch.float32, device=q.device)
    m = torch.empty((B, H), dtype=torch.float32, device=q.device)
    C0, n0, m0 = (t.data_ptr() for t in state) if state is not None else (None, None, None)
    lib = _build.load()
    with torch.cuda.device(q.device):
        err = lib.repro_mlstm(
            q.data_ptr(), k.data_ptr(), v.data_ptr(), gates.data_ptr(), C0, n0, m0,
            h.data_ptr(), C.data_ptr(), n.data_ptr(), m.data_ptr(),
            _build.DTYPE_CODE[q.dtype], B, S, H, hd,
            *q.stride()[:3], *k.stride()[:3], *v.stride()[:3], *h.stride()[:3],
            *gates.stride()[:2], torch.cuda.current_stream(q.device).cuda_stream,
        )
    _build.check(err, "mlstm")
    launches += 1
    return h, (C, n, m)
