"""Launch wrapper of the CUDA flash-attention backward
(``csrc/flash_attention_bwd.cu``, replacing the Pallas ``_dkdv_kernel``
and ``_dq_kernel`` of ``repro/kernels/flash_attention/kernel_bwd.py``).

``flash_attention_bwd`` validates what the kernels take, computes
``delta = sum(do * o)`` per row (a torch reduction, as the JAX package
computes it outside both kernels), allocates the gradients, launches both
kernels on PyTorch's current stream and counts each launch: dk/dv by
variant (bf16 on the tensor-core kernel, ``launches_dkdv_tc``; f32 on the
FMA kernel, ``launches_dkdv_fma``), dq in ``launches_dq``. It never falls
back: anything the kernels do not take raises.
"""
from __future__ import annotations

import ctypes
from typing import Optional, Tuple

import numpy as np
import torch

from repro_torch.kernels import _build
from repro_torch.kernels.flash_attention import kernel

# kernel launches since the last reset (plain ints)
launches_dkdv_tc = 0    # bf16 dk/dv: wgmma + TMA
launches_dkdv_fma = 0   # f32 dk/dv: f32 FMAs
launches_dq = 0         # dq, both dtypes: f32 FMAs


def _rows_ok(t: torch.Tensor) -> bool:
    """The kernels read rows in 16-byte pieces."""
    vec = 16 // t.element_size()
    return t.stride(3) == 1 and not any(s % vec for s in t.stride()[:3]) \
        and t.data_ptr() % 16 == 0


def _check(q, k, v, do, lse, delta) -> None:
    kernel._check(q, k, v)
    B, Sq, H, _ = q.shape
    if do.shape != q.shape or do.dtype != q.dtype or not _rows_ok(do):
        raise ValueError(f"flash_attention_bwd: do{tuple(do.shape)}/{do.dtype} must match "
                         f"q{tuple(q.shape)}/{q.dtype} with 16-byte aligned rows")
    for name, t, shape in (("lse", lse, (B, H, Sq, 1)), ("delta", delta, (B, H, Sq))):
        if tuple(t.shape) != shape or t.dtype != torch.float32 or not t.is_contiguous():
            raise ValueError(f"flash_attention_bwd: {name} must be contiguous f32 {shape}, "
                             f"got {tuple(t.shape)} {t.dtype}")
    if not all(t.device == q.device for t in (do, lse, delta)):
        raise ValueError("flash_attention_bwd: every input must be on q's CUDA device")


def _launch(what, q, k, v, do, lse, delta, outs, causal, window, q_offset, sm_scale):
    """C entry point ``repro_<what>``; ``outs`` are the gradients it writes,
    in its order."""
    _check(q, k, v, do, lse, delta)
    fn = getattr(_build.load(), "repro_" + what)
    B, Sq, H, hd = q.shape
    Skv, KVH = k.shape[1], k.shape[2]
    dq, dk, dv = outs.get("dq", q), outs.get("dk", k), outs.get("dv", v)
    strides = (ctypes.c_longlong * 21)(
        *(s for t in (q, k, v, do, dq, dk, dv) for s in t.stride()[:3])
    )
    scale = sm_scale if sm_scale is not None else float(1.0 / np.sqrt(hd))
    with torch.cuda.device(q.device):
        err = fn(
            q.data_ptr(), k.data_ptr(), v.data_ptr(), do.data_ptr(), lse.data_ptr(),
            delta.data_ptr(), *(t.data_ptr() for t in outs.values()),
            _build.DTYPE_CODE[q.dtype], B, Sq, Skv, H, KVH, hd,
            ctypes.cast(strides, ctypes.c_void_p),
            int(causal), int(window), int(q_offset), float(scale),
            torch.cuda.current_stream(q.device).cuda_stream,
        )
    _build.check(err, what)


def flash_attention_bwd_dkdv(q, k, v, do, lse, delta, *, causal=True, window=0, q_offset=0,
                             sm_scale=None) -> Tuple[torch.Tensor, torch.Tensor]:
    """dk, dv (B, Skv, KVH, hd) in k's dtype: the ``_dkdv_kernel`` port."""
    global launches_dkdv_tc, launches_dkdv_fma
    outs = {"dk": torch.empty(k.shape, dtype=k.dtype, device=k.device),
            "dv": torch.empty(v.shape, dtype=v.dtype, device=v.device)}
    _launch("flash_attention_bwd_dkdv", q, k, v, do, lse, delta, outs,
            causal, window, q_offset, sm_scale)
    if k.dtype == torch.bfloat16:
        launches_dkdv_tc += 1
    else:
        launches_dkdv_fma += 1
    return outs["dk"], outs["dv"]


def flash_attention_bwd_dq(q, k, v, do, lse, delta, *, causal=True, window=0, q_offset=0,
                           sm_scale=None) -> torch.Tensor:
    """dq (B, Sq, H, hd) in q's dtype: the ``_dq_kernel`` port."""
    global launches_dq
    outs = {"dq": torch.empty(q.shape, dtype=q.dtype, device=q.device)}
    _launch("flash_attention_bwd_dq", q, k, v, do, lse, delta, outs,
            causal, window, q_offset, sm_scale)
    launches_dq += 1
    return outs["dq"]


def flash_attention_bwd(
    q: torch.Tensor,       # (B, Sq, H, hd)
    k: torch.Tensor,       # (B, Skv, KVH, hd)
    v: torch.Tensor,       # (B, Skv, KVH, hd)
    o: torch.Tensor,       # (B, Sq, H, hd)   forward output
    lse: torch.Tensor,     # (B, H, Sq, 1)    forward log-sum-exp, f32
    do: torch.Tensor,      # (B, Sq, H, hd)
    *,
    causal: bool = True,
    window: int = 0,
    q_offset: int = 0,
    sm_scale: Optional[float] = None,
) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Returns (dq, dk, dv) in the inputs' layouts and dtype."""
    if o.shape != q.shape or o.dtype != q.dtype or o.device != q.device:
        raise ValueError(f"flash_attention_bwd: o{tuple(o.shape)}/{o.dtype} must match "
                         f"q{tuple(q.shape)}/{q.dtype}")
    if not _rows_ok(do):
        do = do.contiguous()
    delta = (do.float() * o.float()).sum(-1).transpose(1, 2).contiguous()   # (B, H, Sq)
    kw = dict(causal=causal, window=window, q_offset=q_offset, sm_scale=sm_scale)
    dk, dv = flash_attention_bwd_dkdv(q, k, v, do, lse, delta, **kw)
    dq = flash_attention_bwd_dq(q, k, v, do, lse, delta, **kw)
    return dq, dk, dv
