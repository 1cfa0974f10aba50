"""Launch wrappers of the CUDA selective scan (``csrc/ssm_scan.cu``): the
forward replaces the Pallas ``_ssm_kernel``; the backward has no Pallas
counterpart (the reference differentiates a jnp scan).

``ssm_scan`` and ``ssm_scan_bwd`` validate what the kernels take, allocate
the outputs and scratch, launch on PyTorch's current stream and count the
launch in ``launches`` and ``launches_bwd``. They never fall back: anything
the kernels do not take raises. The forward's C entry picks one of two
kernels by S (each case has exactly one): up to ``STEP_MAX`` timesteps (a
decode step) ``ssm_step_kernel``, one thread per state; longer
``ssm_scan_kernel``, 4 states a thread and tiles of ``TILE`` timesteps
staged through shared memory, which with ``keep_chunks`` also writes the
state after each tile but the last. The backward's entry splits time into
segments of ``bwd_segment(...)`` steps and launches
``ssm_scan_bwd_carry_kernel`` (each segment but the first run from a zero
carry: its local gradient and decay product), then ``ssm_scan_bwd_kernel``
(each segment from the carry folded out of the later ones and the kept
states, tile by tile in reverse, 2 states a thread, ``bwd_channels(N)``
channels a block), and then sums its partials in order
(``ssm_sum_parts_kernel``).
"""
from __future__ import annotations

from typing import Optional, Tuple

import torch

from repro_torch.kernels import _build

launches = 0       # forward kernel launches since the last reset (plain int)
launches_bwd = 0   # backward launches (the kernel and its partial sums) since the last reset

STATE_DIMS = (8, 16)
STEP_MAX = 4   # csrc/ssm_scan.cu: up to this many timesteps run the step kernel
TILE = 16      # csrc/ssm_scan.cu's TS: timesteps of a tile, and of a kept chunk
BWD_THREADS, BWD_STATES_PER_LANE = 256, 2   # csrc/ssm_scan.cu's BWD_THREADS and BSPL
# the backward's main pass aims at this many blocks: 8 an SM's worth of an
# H100's 132 (a constant of the design, never read from the device, so the
# same inputs give the same bits on any card)
BWD_SEGMENT_BLOCKS = 8 * 132


def bwd_channels(N: int) -> int:
    """Channels of a backward block (csrc/ssm_scan.cu's BwdStage::CH)."""
    return BWD_THREADS // (N // BWD_STATES_PER_LANE)


def bwd_segment(B: int, S: int, inner: int, N: int) -> int:
    """Timesteps of a backward segment, from the shape alone: the most
    whole tiles a segment may hold while the main pass still has at least
    ``BWD_SEGMENT_BLOCKS`` blocks (channel blocks x segments x batch rows),
    and one tile at least. B1 S4096 inner 3200 N16: 24 tiles (384 steps),
    11 segments, 1100 blocks."""
    tiles = -(-S // TILE)
    blocks = -(-inner // bwd_channels(N)) * B
    return TILE * max(1, tiles * blocks // BWD_SEGMENT_BLOCKS)


def bwd_segments(S: int, seg: int) -> int:
    """Segments of ``seg`` steps over S: at least one (csrc/ssm_scan.cu's ``segments``)."""
    return max(1, -(-S // seg))


def _check(u, dt, B_, C_, A, D, h0, extra=()) -> None:
    dev = u.device
    f32 = [t for t in (dt, B_, C_, A, D, h0, *extra) if t is not None]
    if dev.type not in ("cuda", "meta") or any(t.device != dev for t in f32):
        raise ValueError("ssm_scan kernel: all inputs must be on one CUDA (or meta) device")
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


def n_chunks(S: int) -> int:
    """Kept states of a forward over S steps: one after each tile but the
    last (none when the step kernel runs it)."""
    return 0 if S <= STEP_MAX else max(-(-S // TILE) - 1, 0)


def ssm_scan(
    u: torch.Tensor,        # (B, S, inner) f32 or bf16
    dt: torch.Tensor,       # (B, S, inner) f32
    B_: torch.Tensor,       # (B, S, N) f32
    C_: torch.Tensor,       # (B, S, N) f32
    A: torch.Tensor,        # (inner, N) f32
    D: torch.Tensor,        # (inner,) f32
    h0: Optional[torch.Tensor] = None,   # (B, inner, N) f32; None = zeros
    keep_chunks: bool = False,
):
    """Returns (y (B,S,inner) in u's dtype, h_final (B,inner,N) f32), and
    with ``keep_chunks`` a third output, the states after each tile but the
    last (B, n_chunks(S), inner, N) f32, for ``ssm_scan_bwd``."""
    global launches
    _check(u, dt, B_, C_, A, D, h0)
    Bb, S, inner = u.shape
    N = A.shape[1]
    y = torch.empty_like(u)
    h_out = torch.empty((Bb, inner, N), dtype=torch.float32, device=u.device)
    chunks = (torch.empty((Bb, n_chunks(S), inner, N), dtype=torch.float32, device=u.device)
              if keep_chunks else None)
    if _build.launch(
            "repro_ssm_scan", "ssm_scan", u.device,
            (u.data_ptr(), dt.data_ptr(), B_.data_ptr(), C_.data_ptr(), A.data_ptr(),
             D.data_ptr(), None if h0 is None else h0.data_ptr(), y.data_ptr(),
             h_out.data_ptr(),
             None if chunks is None or chunks.numel() == 0 else chunks.data_ptr(),
             _build.DTYPE_CODE[u.dtype], Bb, S, inner, N, _build.STREAM),
            B=Bb, S=S, inner=inner, N=N, el=u.element_size(), h0=h0 is not None):
        launches += 1
    return (y, h_out) if not keep_chunks else (y, h_out, chunks)


def ssm_scan_bwd(
    u: torch.Tensor, dt: torch.Tensor, B_: torch.Tensor, C_: torch.Tensor, A: torch.Tensor,
    D: torch.Tensor, h0: Optional[torch.Tensor], chunks: torch.Tensor, dy: torch.Tensor,
    dh: Optional[torch.Tensor] = None,
) -> Tuple[torch.Tensor, ...]:
    """The scan's gradient from the forward's inputs, its kept states
    ``chunks`` and the gradients of its outputs: ``dy`` (B, S, inner) in
    u's dtype and ``dh`` (B, inner, N) f32 or None (zeros). Returns (du in
    u's dtype, ddt, dB_, dC_, dA, dD, dh0 or None when ``h0`` is None), all
    but du f32."""
    global launches_bwd
    _check(u, dt, B_, C_, A, D, h0, extra=(chunks, dh))
    Bb, S, inner = u.shape
    N = A.shape[1]
    if dy.dtype != u.dtype or tuple(dy.shape) != tuple(u.shape) or not dy.is_contiguous() \
            or dy.device != u.device:
        raise ValueError(f"ssm_scan_bwd kernel: dy {dy.dtype}{tuple(dy.shape)} must be "
                         f"contiguous like u {u.dtype}{tuple(u.shape)}")
    if tuple(chunks.shape) != (Bb, n_chunks(S), inner, N):
        raise ValueError(f"ssm_scan_bwd kernel: chunks{tuple(chunks.shape)}, expected "
                         f"{(Bb, n_chunks(S), inner, N)}")
    if dh is not None and tuple(dh.shape) != (Bb, inner, N):
        raise ValueError(f"ssm_scan_bwd kernel: dh{tuple(dh.shape)}, expected {(Bb, inner, N)}")
    f32 = dict(dtype=torch.float32, device=u.device)
    du = torch.empty_like(u)
    ddt = torch.empty((Bb, S, inner), **f32)
    dBC = torch.empty((2, Bb, S, N), **f32)
    dAD = torch.empty((inner * N + inner,), **f32)
    dh0 = torch.empty((Bb, inner, N), **f32) if h0 is not None else None
    blocks = -(-inner // bwd_channels(N))
    seg = bwd_segment(Bb, S, inner, N)
    NS = bwd_segments(S, seg)
    carry = torch.empty((2, Bb, NS - 1, inner, N), **f32)
    part_bc = torch.empty((blocks, 2, Bb, S, N), **f32)
    part_ad = torch.empty((Bb, NS, inner * N + inner), **f32)
    ptr = lambda t: None if t is None or t.numel() == 0 else t.data_ptr()
    if _build.launch(
            "repro_ssm_scan_bwd", "ssm_scan_bwd", u.device,
            (u.data_ptr(), dt.data_ptr(), B_.data_ptr(), C_.data_ptr(), A.data_ptr(),
             D.data_ptr(), ptr(h0), ptr(chunks), dy.data_ptr(), ptr(dh), du.data_ptr(),
             ddt.data_ptr(), dBC.data_ptr(), dAD.data_ptr(), ptr(dh0), ptr(carry),
             ptr(part_bc), part_ad.data_ptr(), _build.DTYPE_CODE[u.dtype], Bb, S, inner, N,
             seg, _build.STREAM),
            B=Bb, S=S, inner=inner, N=N, el=u.element_size()):
        launches_bwd += 1
    return (du, ddt, dBC[0], dBC[1], dAD[:inner * N].view(inner, N), dAD[inner * N:], dh0)
