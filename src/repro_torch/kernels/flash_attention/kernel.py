"""Launch wrapper of the CUDA flash-attention forward
(``csrc/flash_attention.cu``, replacing the Pallas ``_flash_kernel``).

``flash_attention_fwd`` validates what the kernels take, allocates the
outputs, launches on PyTorch's current stream and counts the launch by
variant: bf16 runs the tensor-core kernel (``launches_tc``), f32 the FMA
kernel (``launches_fma``). It never falls back: anything the kernels do
not take raises.
"""
from __future__ import annotations

from typing import Optional, Tuple

import numpy as np
import torch

from repro_torch.kernels import _build

# kernel launches since the last reset, by variant (plain ints)
launches_tc = 0    # bf16: wgmma + TMA
launches_fma = 0   # f32: f32 FMAs

HEAD_DIMS = (32, 64, 128)


def _check(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor) -> None:
    if not (q.is_cuda and k.device == q.device and v.device == q.device):
        raise ValueError("flash_attention kernel: q, k, v must be on one CUDA device")
    if q.dtype not in _build.DTYPE_CODE or k.dtype != q.dtype or v.dtype != q.dtype:
        raise ValueError(f"flash_attention kernel: dtype {q.dtype}/{k.dtype}/{v.dtype} "
                         f"(one of float32, bfloat16)")
    if q.dim() != 4 or k.dim() != 4 or k.shape != v.shape:
        raise ValueError(f"flash_attention kernel: shapes q{tuple(q.shape)} "
                         f"k{tuple(k.shape)} v{tuple(v.shape)}")
    B, _, H, hd = q.shape
    if k.shape[0] != B or k.shape[3] != hd or H % k.shape[2] != 0:
        raise ValueError(f"flash_attention kernel: q{tuple(q.shape)} vs k{tuple(k.shape)}")
    if hd not in HEAD_DIMS:
        raise ValueError(f"flash_attention kernel: head_dim {hd} not in {HEAD_DIMS}")
    vec = 16 // q.element_size()  # the kernel reads rows in 16-byte pieces
    for t in (q, k, v):
        if t.stride(3) != 1 or any(s % vec for s in t.stride()[:3]) or t.data_ptr() % 16:
            raise ValueError("flash_attention kernel: rows must be contiguous and 16-byte "
                             f"aligned (strides {t.stride()})")


def flash_attention_fwd(
    q: torch.Tensor,       # (B, Sq, H, hd)
    k: torch.Tensor,       # (B, Skv, KVH, hd)
    v: torch.Tensor,       # (B, Skv, KVH, hd)
    *,
    causal: bool = True,
    window: int = 0,
    q_offset: int = 0,
    sm_scale: Optional[float] = None,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Returns o (B, Sq, H, hd) in q's dtype and lse (B, H, Sq, 1) f32."""
    global launches_tc, launches_fma
    _check(q, k, v)
    B, Sq, H, hd = q.shape
    Skv, KVH = k.shape[1], k.shape[2]
    scale = sm_scale if sm_scale is not None else float(1.0 / np.sqrt(hd))
    o = torch.empty((B, Sq, H, hd), dtype=q.dtype, device=q.device)
    lse = torch.empty((B, H, Sq, 1), dtype=torch.float32, device=q.device)
    lib = _build.load()
    with torch.cuda.device(q.device):
        err = lib.repro_flash_attention_fwd(
            q.data_ptr(), k.data_ptr(), v.data_ptr(), o.data_ptr(), lse.data_ptr(),
            _build.DTYPE_CODE[q.dtype], B, Sq, Skv, H, KVH, hd,
            *q.stride()[:3], *k.stride()[:3], *v.stride()[:3], *o.stride()[:3],
            int(causal), int(window), int(q_offset), float(scale),
            torch.cuda.current_stream(q.device).cuda_stream,
        )
    _build.check(err, "flash_attention")
    if q.dtype == torch.bfloat16:
        launches_tc += 1
    else:
        launches_fma += 1
    return o, lse
