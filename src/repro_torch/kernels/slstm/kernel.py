"""Launch wrappers of the CUDA sLSTM recurrence (``csrc/slstm.cu``), which
replaces no Pallas kernel but the reference's ``lax.scan`` over the steps
(``repro/models/xlstm.py:226-239``).

``slstm`` launches the forward (counted in ``launches``) and ``slstm_bwd``
the backward (``launches_bwd``), each once a call: a persistent grid of one
block per U hidden units, all resident at once (a cooperative launch),
exchanging h (the forward) or each block's share of dpre r^T (the backward)
between steps as step-tagged words. U is 8 (``slstm_fwd_kernel``,
``slstm_bwd_kernel``) where d / 8 blocks fit the card, else 16, 32 or 64
(the ``*_wide_kernel``s), chosen by the library from the shape, the SM
count and the instantiation's occupancy (``units``). A d that 32 does not
divide is padded with zero units (``pad_units``), which is exact for the
real ones: a padded unit's gates are 0, so its c and h stay 0, and its
rows of r are 0, so it feeds nothing; the outputs are sliced back
(``unpad_units``; ``padded_call`` and ``padded_bwd_call`` wrap the
launches, and take the plain versions as well). Each wrapper validates what its kernel takes, allocates
the outputs, the kept tensors and the exchange buffer (zeroed on the
current stream) and launches on PyTorch's current stream; a shape no grid
fits raises.
"""
from __future__ import annotations

from typing import Optional, Tuple

import torch

from repro_torch.kernels import _build
from repro_torch.kernels.slstm.ref import Kept, State

launches = 0        # kernel launches since the last reset (plain ints)
launches_bwd = 0

UNITS = 8           # units a block of the 8-unit grids (the wide ones take 16-64)
PAD = 32            # the kernels take a d that this divides


def padded(d: int) -> int:
    return -(-d // PAD) * PAD


def pad_units(t: Optional[torch.Tensor], d: int, dp: int, rows: bool = False):
    """``t`` with its last dimension's blocks of d units (1 or 4 gate blocks)
    each padded with zeros to dp, and with ``rows`` its first dimension too
    (r: (d, 4d) -> (dp, 4dp)). None stays None."""
    if t is None or dp == d:
        return t
    lead, blocks = t.shape[:-1], t.shape[-1] // d
    out = t.new_zeros(*lead, blocks, dp)
    out[..., :d] = t.reshape(*lead, blocks, d)
    out = out.reshape(*lead, blocks * dp)
    if rows:
        full = out.new_zeros(dp, *out.shape[1:])
        full[:d] = out
        out = full
    return out


def unpad_units(t: Optional[torch.Tensor], d: int, dp: int, rows: bool = False):
    """The inverse of ``pad_units``: the real units' values, contiguous."""
    if t is None or dp == d:
        return t
    lead, blocks = t.shape[:-1], t.shape[-1] // dp
    out = t.reshape(*lead, blocks, dp)[..., :d].reshape(*lead, blocks * d)
    return (out[:d] if rows else out).contiguous()


# one H100 (132 SMs, one block of any of the kernels an SM): what the meta
# device stands for
H100_SMS = 132


def h100_units(d: int) -> int:
    """The units a block the library picks on an H100 (d a multiple of PAD):
    the fewest of 8, 16, 32, 64 that divide d into at most 132 blocks; 0
    where none does. ``chip_smoke.py`` holds it equal to ``units`` on the
    card at every width it runs."""
    return next((u for u in (8, 16, 32, 64) if d % u == 0 and d // u <= H100_SMS), 0)


def units(B: int, d: int, backward: bool = False, device=None) -> int:
    """Hidden units a block of the grid launched at (B, d) owns, as the
    library picks them for the current device (d a multiple of PAD), or on
    the meta device as on an H100 (``h100_units``); raises where no grid
    fits."""
    device = torch.device("cuda" if device is None else device)
    if device.type == "meta":
        u = h100_units(d)
    else:
        with torch.cuda.device(device):
            u = _build.load().repro_slstm_units(B, d, int(backward))
    if u == 0:
        raise RuntimeError(f"slstm kernel: no grid of 8-64 units a block fits d {d} at B {B} "
                           f"on this device")
    return u


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
    if wx.device.type not in ("cuda", "meta"):
        raise ValueError("slstm kernel: inputs must be on a CUDA (or meta) device")
    if wx.dim() != 3 or wx.shape[2] % 4:
        raise ValueError(f"slstm kernel: wx{tuple(wx.shape)} is not (B, S, 4d)")
    B, S, d = wx.shape[0], wx.shape[1], wx.shape[2] // 4
    if d < 1 or S < 1 or B < 1:
        raise ValueError(f"slstm kernel: d {d}, S {S} and B {B} (at least 1)")
    _check_f32("wx", wx, (B, S, 4 * d), wx.device)
    _check_f32("r", r, (d, 4 * d), wx.device)
    for name, t in zip("cnhm", state or ()):
        _check_f32(f"state {name}", t, (B, d), wx.device)
    return B, S, d


def _exchange(B: int, S: int, d: int, dev) -> Optional[torch.Tensor]:
    """The forward's two slots of step-tagged h, zeroed (no step's tag); a
    single step exchanges nothing."""
    return torch.zeros((2, B, d), dtype=torch.int64, device=dev) if S > 1 else None


def _bwd_exchange(B: int, S: int, d: int, with_state: bool, dev,
                  u: int = UNITS) -> Optional[torch.Tensor]:
    """The backward's two slots of step-tagged partial sums of dpre r^T, (B,
    d / u, d): each block's share for every unit, zeroed; nothing crosses the
    grid at one step without a start state (with one, dh0 reads step 0's
    shares), and that call gets none."""
    if S == 1 and not with_state:
        return None
    return torch.zeros((2, B, d // u, d), dtype=torch.int64, device=dev)


def slstm(
    wx: torch.Tensor,                 # (B, S, 4d) f32: x w_gates + b_gates
    r: torch.Tensor,                  # (d, 4d) f32
    state: Optional[State] = None,    # (c, n, h, m) f32 (B, d) each; None: zeros
    keep: bool = False,
):
    """Returns (hs (B, S, d), (c, n, h, m)) f32; with ``keep`` also what the
    gradient starts from (``Kept``), a third element. ``state`` is only read."""
    _check(wx, r, state)
    return padded_call(_slstm, wx, r, state, keep)


def padded_call(fn, wx, r, state=None, keep: bool = False):
    """``fn`` (a forward with ``slstm``'s arguments and results at a d that
    PAD divides: the kernel's launch, or a plain version) on ``wx``, ``r``
    and ``state`` padded to the next multiple of PAD, its results sliced
    back to d."""
    d = wx.shape[2] // 4
    dp = padded(d)
    if dp == d:
        return fn(wx, r, state, keep)
    out = fn(pad_units(wx, d, dp), pad_units(r, d, dp, rows=True),
             None if state is None else tuple(pad_units(t, d, dp) for t in state), keep)
    return tuple(x if torch.is_tensor(x) else tuple(unpad_units(t, d, dp) for t in x)
                 for x in (unpad_units(out[0], d, dp), *out[1:]))


def _slstm(wx, r, state, keep):
    global launches
    B, S, d = wx.shape[0], wx.shape[1], wx.shape[2] // 4
    dev = wx.device
    e = lambda *shape: torch.empty(shape, dtype=torch.float32, device=dev)
    hs = e(B, S, d)
    final = (e(B, d), e(B, d), e(B, d), e(B, d))
    kept = (e(B, S, 4 * d), e(B, S, d), e(B, S, d), e(B, S, d)) if keep else (None,) * 4
    st = state if state is not None else (None,) * 4
    exchange = _exchange(B, S, d, dev)
    if _build.launch(
            "repro_slstm_fwd", "slstm", dev,
            (wx.data_ptr(), r.data_ptr(), *(_ptr(t) for t in st), hs.data_ptr(),
             *(t.data_ptr() for t in final), *(_ptr(t) for t in kept), _ptr(exchange),
             B, S, d, _build.STREAM),
            B=B, S=S, d=d):
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
    _check(kept[0], r, state)                    # kept pre is (B, S, 4d), as wx
    return padded_bwd_call(_slstm_bwd, r, state, hs, kept, dhs, dstate)


def padded_bwd_call(fn, r, state, hs, kept, dhs, dstate=None):
    """``fn`` (a gradient with ``slstm_bwd``'s arguments and results at a d
    that PAD divides) on its arguments padded to the next multiple of PAD,
    its results sliced back to d. A padded unit's kept n and m are 0, not
    what its forward computed: its gradient is 0 either way, since nothing
    reaches its h."""
    dstate = tuple(dstate) if dstate is not None else (None,) * 4
    d = hs.shape[2]
    dp = padded(d)
    if dp == d:
        return fn(r, state, hs, kept, dhs, dstate)
    pad = lambda t: pad_units(t, d, dp)
    dwx, dr, d0 = fn(pad_units(r, d, dp, rows=True),
                     None if state is None else tuple(map(pad, state)), pad(hs),
                     tuple(map(pad, kept)), pad(dhs), tuple(map(pad, dstate)))
    return (unpad_units(dwx, d, dp), unpad_units(dr, d, dp, rows=True),
            None if d0 is None else tuple(unpad_units(t, d, dp) for t in d0))


def _slstm_bwd(r, state, hs, kept, dhs, dstate):
    global launches_bwd
    B, S, d = hs.shape
    dstate = tuple(dstate)
    dev = r.device
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
    u = units(B, d, backward=True, device=dev)
    exchange = _bwd_exchange(B, S, d, state is not None, dev, u)
    rT = r.t().contiguous() if u > 8 else None     # the wide kernel reads r by columns
    if _build.launch(
            "repro_slstm_bwd", "slstm_bwd", dev,
            (r.data_ptr(), hs.data_ptr(), *(t.data_ptr() for t in kept),
             _ptr(st[0]), _ptr(st[1]), _ptr(st[3]), _ptr(dhs), *(_ptr(t) for t in dstate),
             dpre.data_ptr(), *(_ptr(t) for t in d0), _ptr(exchange),
             B, S, d, _build.STREAM, _ptr(rT)),
            B=B, S=S, d=d):
        launches_bwd += 1
    h0 = st[2] if st[2] is not None else torch.zeros((B, d), dtype=torch.float32, device=dev)
    h_prev = torch.cat([h0[:, None], hs[:, :-1]], dim=1)
    dr = torch.matmul(h_prev.reshape(B * S, d).T, dpre.reshape(B * S, 4 * d))
    return dpre, dr, (d0 if state is not None else None)
