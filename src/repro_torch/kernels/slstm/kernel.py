"""Launch wrappers of the CUDA sLSTM recurrence (``csrc/slstm.cu``), which
replaces no Pallas kernel but the reference's ``lax.scan`` over the steps
(``repro/models/xlstm.py:226-239``).

``slstm`` launches ``slstm_fwd_kernel`` (counted in ``launches``) and
``slstm_bwd`` launches ``slstm_bwd_kernel`` (``launches_bwd``), each once a
call: a persistent grid of one block per 8 hidden units, all resident at
once (a cooperative launch, refused rather than deadlocked when they do not
fit), exchanging h (the forward) or each block's share of dpre r^T (the
backward) between steps as step-tagged words. Each wrapper validates what
its kernel takes, allocates the outputs, the kept tensors and the exchange
buffer (zeroed on the current stream) and launches on PyTorch's current
stream; anything the kernel does not take raises.
"""
from __future__ import annotations

from typing import Optional, Tuple

import torch

from repro_torch.kernels import _build
from repro_torch.kernels.slstm.ref import Kept, State

launches = 0        # kernel launches since the last reset (plain ints)
launches_bwd = 0

UNITS = 8           # hidden units a block owns (csrc/slstm.cu's U)


def _ptr(t: Optional[torch.Tensor]):
    return None if t is None else t.data_ptr()


def _check_f32(what: str, t: torch.Tensor, shape: tuple, dev) -> None:
    if t.device != dev or t.dtype != torch.float32:
        raise ValueError(f"slstm kernel: {what} must be float32 on {dev}, got {t.dtype} on "
                         f"{t.device}")
    if tuple(t.shape) != tuple(shape) or not t.is_contiguous():
        raise ValueError(f"slstm kernel: {what}{tuple(t.shape)}, expected a contiguous "
                         f"{tuple(shape)}")


def _check(wx: torch.Tensor, r: torch.Tensor, state: Optional[State]) -> Tuple[int, int, int]:
    if not wx.is_cuda:
        raise ValueError("slstm kernel: inputs must be on a CUDA device")
    if wx.dim() != 3 or wx.shape[2] % 4:
        raise ValueError(f"slstm kernel: wx{tuple(wx.shape)} is not (B, S, 4d)")
    B, S, d = wx.shape[0], wx.shape[1], wx.shape[2] // 4
    if d % 32 or S < 1 or B < 1:
        raise ValueError(f"slstm kernel: d {d} (a multiple of 32), S {S} and B {B} (at least 1)")
    _check_f32("wx", wx, (B, S, 4 * d), wx.device)
    _check_f32("r", r, (d, 4 * d), wx.device)
    for name, t in zip("cnhm", state or ()):
        _check_f32(f"state {name}", t, (B, d), wx.device)
    return B, S, d


def _exchange(B: int, S: int, d: int, dev) -> Optional[torch.Tensor]:
    """The forward's two slots of step-tagged h, zeroed (no step's tag); a
    single step exchanges nothing."""
    return torch.zeros((2, B, d), dtype=torch.int64, device=dev) if S > 1 else None


def _bwd_exchange(B: int, S: int, d: int, with_state: bool, dev) -> Optional[torch.Tensor]:
    """The backward's two slots of step-tagged partial sums of dpre r^T, (B,
    d / 8, d): each block's share for every unit, zeroed; nothing crosses the
    grid at one step without a start state (with one, dh0 reads step 0's
    shares), and that call gets none."""
    if S == 1 and not with_state:
        return None
    return torch.zeros((2, B, d // UNITS, d), dtype=torch.int64, device=dev)


def slstm(
    wx: torch.Tensor,                 # (B, S, 4d) f32: x w_gates + b_gates
    r: torch.Tensor,                  # (d, 4d) f32
    state: Optional[State] = None,    # (c, n, h, m) f32 (B, d) each; None: zeros
    keep: bool = False,
):
    """Returns (hs (B, S, d), (c, n, h, m)) f32; with ``keep`` also what the
    gradient starts from (``Kept``), a third element. ``state`` is only read."""
    global launches
    B, S, d = _check(wx, r, state)
    dev = wx.device
    e = lambda *shape: torch.empty(shape, dtype=torch.float32, device=dev)
    hs = e(B, S, d)
    final = (e(B, d), e(B, d), e(B, d), e(B, d))
    kept = (e(B, S, 4 * d), e(B, S, d), e(B, S, d), e(B, S, d)) if keep else (None,) * 4
    st = state if state is not None else (None,) * 4
    exchange = _exchange(B, S, d, dev)
    with torch.cuda.device(dev):
        err = _build.load().repro_slstm_fwd(
            wx.data_ptr(), r.data_ptr(), *(_ptr(t) for t in st), hs.data_ptr(),
            *(t.data_ptr() for t in final), *(_ptr(t) for t in kept), _ptr(exchange),
            B, S, d, torch.cuda.current_stream(dev).cuda_stream)
    _build.check(err, "slstm")
    launches += 1
    return (hs, final, kept) if keep else (hs, final)


def slstm_bwd(
    r: torch.Tensor,                  # (d, 4d) f32
    state: Optional[State],           # the forward's start state, None: zeros
    hs: torch.Tensor,                 # (B, S, d) the forward's output
    kept: Kept,                       # what the forward kept (``keep=True``)
    dhs: Optional[torch.Tensor],      # (B, S, d); None: zeros
    dstate: Optional[Tuple[Optional[torch.Tensor], ...]] = None,   # final (dc, dn, dh, dm)
):
    """The sLSTM's gradient on the card. Returns (dwx (B, S, 4d), dr (d,
    4d), the start state's (dc, dn, dh, dm) when ``state`` is given, else
    None), f32. The kernel writes dwx (each step's dpre) and the start
    state's gradient; ``dr`` is one product of the h each step read with
    dpre, left to cuBLAS as the reference leaves it to XLA."""
    global launches_bwd
    B, S, d = _check(kept[0], r, state)          # kept pre is (B, S, 4d), as wx
    dev = r.device
    dstate = tuple(dstate) if dstate is not None else (None,) * 4
    for name, t in (("hs", hs), ("kept c", kept[1]), ("kept n", kept[2]), ("kept m", kept[3]),
                    ("dhs", dhs)):
        if t is not None:
            _check_f32(name, t, (B, S, d), dev)
    for name, t in zip("cnhm", dstate):
        if t is not None:
            _check_f32(f"dstate {name}", t, (B, d), dev)
    e = lambda *shape: torch.empty(shape, dtype=torch.float32, device=dev)
    dpre = e(B, S, 4 * d)
    d0 = (e(B, d), e(B, d), e(B, d), e(B, d)) if state is not None else (None,) * 4
    st = state if state is not None else (None,) * 4
    exchange = _bwd_exchange(B, S, d, state is not None, dev)
    with torch.cuda.device(dev):
        err = _build.load().repro_slstm_bwd(
            r.data_ptr(), hs.data_ptr(), *(t.data_ptr() for t in kept),
            _ptr(st[0]), _ptr(st[1]), _ptr(st[3]), _ptr(dhs), *(_ptr(t) for t in dstate),
            dpre.data_ptr(), *(_ptr(t) for t in d0), _ptr(exchange),
            B, S, d, torch.cuda.current_stream(dev).cuda_stream)
    _build.check(err, "slstm_bwd")
    launches_bwd += 1
    h0 = st[2] if st[2] is not None else torch.zeros((B, d), dtype=torch.float32, device=dev)
    h_prev = torch.cat([h0[:, None], hs[:, :-1]], dim=1)
    dr = torch.matmul(h_prev.reshape(B * S, d).T, dpre.reshape(B * S, 4 * d))
    return dpre, dr, (d0 if state is not None else None)
