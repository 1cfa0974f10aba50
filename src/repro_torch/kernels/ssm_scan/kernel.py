"""Launch wrapper of the CUDA selective scan (``csrc/ssm_scan.cu``,
replacing the Pallas ``_ssm_kernel``).

``ssm_scan`` validates what the kernel takes, allocates the outputs,
launches on PyTorch's current stream and counts the launch in
``launches``. It never falls back: anything the kernel does not take
raises. The C entry picks one of two kernels by S (each case has exactly
one): up to ``STEP_MAX`` timesteps (a decode step) ``ssm_step_kernel``,
one thread per state; longer ``ssm_scan_kernel``, 4 states a thread and
tiles of timesteps staged through shared memory.
"""
from __future__ import annotations

from typing import Optional, Tuple

import torch

from repro_torch.kernels import _build

launches = 0   # kernel launches since the last reset (plain int)

STATE_DIMS = (8, 16)
STEP_MAX = 4   # csrc/ssm_scan.cu: up to this many timesteps run the step kernel


def _check(u, dt, B_, C_, A, D, h0) -> None:
    dev = u.device
    f32 = [t for t in (dt, B_, C_, A, D, h0) if t is not None]
    if not u.is_cuda or any(t.device != dev for t in f32):
        raise ValueError("ssm_scan kernel: all inputs must be on one CUDA device")
    if u.dtype not in _build.DTYPE_CODE or any(t.dtype != torch.float32 for t in f32):
        raise ValueError(f"ssm_scan kernel: u {u.dtype} (float32 or bfloat16); dt, B_, C_, "
                         f"A, D, h0 must be float32, got {[t.dtype for t in f32]}")
    if u.dim() != 3:
        raise ValueError(f"ssm_scan kernel: u{tuple(u.shape)} is not (B, S, inner)")
    Bb, S, inner = u.shape
    N = A.shape[-1]
    want = {"dt": (dt, (Bb, S, inner)), "B_": (B_, (Bb, S, N)), "C_": (C_, (Bb, S, N)),
            "A": (A, (inner, N)), "D": (D, (inner,))}
    if h0 is not None:
        want["h0"] = (h0, (Bb, inner, N))
    for name, (t, shape) in want.items():
        if tuple(t.shape) != shape:
            raise ValueError(f"ssm_scan kernel: {name}{tuple(t.shape)}, expected {shape}")
    if N not in STATE_DIMS:
        raise ValueError(f"ssm_scan kernel: state dim {N} (one of {STATE_DIMS})")
    if Bb > 65535:
        raise ValueError(f"ssm_scan kernel: batch {Bb} exceeds the grid's 65535 rows")
    if not all(t.is_contiguous() for t in [u, *f32]):
        raise ValueError("ssm_scan kernel: inputs must be contiguous")


def ssm_scan(
    u: torch.Tensor,        # (B, S, inner) f32 or bf16
    dt: torch.Tensor,       # (B, S, inner) f32
    B_: torch.Tensor,       # (B, S, N) f32
    C_: torch.Tensor,       # (B, S, N) f32
    A: torch.Tensor,        # (inner, N) f32
    D: torch.Tensor,        # (inner,) f32
    h0: Optional[torch.Tensor] = None,   # (B, inner, N) f32; None = zeros
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Returns (y (B,S,inner) in u's dtype, h_final (B,inner,N) f32)."""
    global launches
    _check(u, dt, B_, C_, A, D, h0)
    Bb, S, inner = u.shape
    N = A.shape[1]
    y = torch.empty_like(u)
    h_out = torch.empty((Bb, inner, N), dtype=torch.float32, device=u.device)
    lib = _build.load()
    with torch.cuda.device(u.device):
        err = lib.repro_ssm_scan(
            u.data_ptr(), dt.data_ptr(), B_.data_ptr(), C_.data_ptr(), A.data_ptr(),
            D.data_ptr(), None if h0 is None else h0.data_ptr(), y.data_ptr(),
            h_out.data_ptr(), _build.DTYPE_CODE[u.dtype], Bb, S, inner, N,
            torch.cuda.current_stream(u.device).cuda_stream,
        )
    _build.check(err, "ssm_scan")
    launches += 1
    return y, h_out
