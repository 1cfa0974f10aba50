"""Launch wrappers of the CUDA chunkwise mLSTM (``csrc/mlstm.cu`` and
``csrc/mlstm_tc.cu``, replacing the Pallas ``_mlstm_kernel``).

Each wrapper validates what its kernel takes, allocates the outputs and
launches on PyTorch's current stream, counting the launch in its own
counter; anything the kernel does not take raises.

``mlstm``, the one the model calls, picks by the inputs (not a fallback:
each case has exactly one kernel):

* S <= ``STEP_MAX`` (a decode step), either dtype: the one-pass step
  kernel (``launches_step``);
* longer, bf16 with a head_dim and layout the tensor-core kernel takes
  (``_tc_takes``): the chunkwise kernel on tensor cores (``launches_tc``);
* longer otherwise (f32, or another head_dim): the chunkwise kernel with
  every product on the tensor cores as split TF32 (``launches_tf32``).

``mlstm_tc`` and ``mlstm_tf32`` call one chunkwise kernel each whatever the
inputs, for the checks on the card; with ``keep=True`` they also return what
the gradient starts from (each 64-step chunk's start state and each step's
n·q). The tensor-core kernel has two designs of one function:
``tc_design`` picks by shape alone (the split's carry and output passes,
or the single pass), and ``tc_call`` runs a named one for the checks.
``mlstm_bwd`` launches the gradient (``csrc/mlstm_bwd.cu``: its per-step
scalars, its carry pass, its parallel pass and the sums, one call in
``launches_bwd``).
"""
from __future__ import annotations

from typing import Optional, Tuple

import ctypes

import torch

from repro_torch.kernels import _build

launches_tc = 0     # kernel launches since the last reset (plain ints), by variant
launches_tf32 = 0
launches_step = 0
launches_bwd = 0

MAX_HEAD_DIM = 512   # the kernels keep a tile of C's rows (rows x hd f32) on chip
STEP_MAX = 8         # up to this many timesteps run in one pass over C
CHUNK = 64           # the chunkwise kernels' chunk: what they keep is per chunk of it
TC_SPLIT_BELOW = 128   # single-pass blocks below which the split design runs (``tc_design``)

# what a chunkwise forward keeps for the gradient: C, n, m at each chunk's
# start and each step's n·q
Kept = Tuple[torch.Tensor, torch.Tensor, torch.Tensor, torch.Tensor]


def _check(q, k, v, gates, state) -> None:
    dev = q.device
    f32 = [gates, *(state or ())]
    if dev.type not in ("cuda", "meta") or any(t.device != dev for t in (k, v, *f32)):
        raise ValueError("mlstm kernel: all inputs must be on one CUDA (or meta) device")
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
        if state[0].data_ptr() % 16:
            raise ValueError("mlstm kernel: state C must be 16-byte aligned")


def _tc_takes(q, k, v) -> bool:
    """Whether the tensor-core kernel takes these q/k/v: bf16, head_dim a
    multiple of 64, TMA's 16-byte alignment of base and strides."""
    return (q.dtype == torch.bfloat16 and q.shape[3] % 64 == 0
            and not any(t.data_ptr() % 16 or any(st % 8 for st in t.stride()[:3])
                        for t in (q, k, v)))


def _check_tc(q, k, v) -> None:
    if not _tc_takes(q, k, v):
        raise ValueError(f"mlstm tensor-core kernel: q/k/v must be bf16 (got {q.dtype}) with "
                         f"a head_dim that is a multiple of 64 (got {q.shape[3]}), 16-byte "
                         f"aligned with strides of whole 16-byte units (TMA)")


def _kept(B, S, H, hd, device) -> Kept:
    nc = -(-S // CHUNK)
    f32 = lambda *shape: torch.empty(shape, dtype=torch.float32, device=device)
    return f32(B, H, nc, hd, hd), f32(B, H, nc, hd), f32(B, H, nc), f32(B, S, H)


def bwd_tile(hd: int) -> int:
    """The columns of the value-row tiles the gradient splits C into
    (csrc/mlstm_bwd.cu's VT): it sizes the tile workspaces."""
    return 64 if hd % 64 == 0 else 32


def _launch(entry, what, extra, q, k, v, gates, state):
    """Allocates h and the final state, launches C entry point ``entry``
    with ``extra`` (the arguments between the outputs' pointers and the
    shape), raises on a CUDA error, and returns (h, (C, n, m), launched)."""
    B, S, H, hd = q.shape
    h = torch.empty((B, S, H, hd), dtype=q.dtype, device=q.device)
    C = torch.empty((B, H, hd, hd), dtype=torch.float32, device=q.device)
    n = torch.empty((B, H, hd), dtype=torch.float32, device=q.device)
    m = torch.empty((B, H), dtype=torch.float32, device=q.device)
    C0, n0, m0 = (t.data_ptr() for t in state) if state is not None else (None, None, None)
    launched = _build.launch(
        entry, what, q.device,
        (q.data_ptr(), k.data_ptr(), v.data_ptr(), gates.data_ptr(), C0, n0, m0,
         h.data_ptr(), C.data_ptr(), n.data_ptr(), m.data_ptr(), *extra, B, S, H, hd,
         *q.stride()[:3], *k.stride()[:3], *v.stride()[:3], *h.stride()[:3],
         *gates.stride()[:2], _build.STREAM),
        B=B, S=S, H=H, hd=hd, el=q.element_size(), state=state is not None)
    return h, (C, n, m), launched


def _launch_chunkwise(entry, what, extra, q, k, v, gates, state, keep: bool):
    """``_launch`` of a chunkwise kernel, which takes four pointers for what
    the gradient starts from before ``extra`` (NULL: keep nothing); with
    ``keep`` they are allocated and returned after the state."""
    kept = _kept(*q.shape, q.device) if keep else None
    ptrs = tuple(t.data_ptr() for t in kept) if keep else (None,) * 4
    h, st, launched = _launch(entry, what, (*ptrs, *extra), q, k, v, gates, state)
    return ((h, st, kept) if keep else (h, st)), launched


def mlstm(
    q: torch.Tensor,       # (B, S, H, hd) f32 or bf16, rows contiguous
    k: torch.Tensor,
    v: torch.Tensor,
    gates: torch.Tensor,   # (B, S, 2H) f32: ĩ in [..., :H], f̃ in [..., H:]
    state: Optional[Tuple[torch.Tensor, torch.Tensor, torch.Tensor]] = None,
) -> Tuple[torch.Tensor, Tuple[torch.Tensor, torch.Tensor, torch.Tensor]]:
    """Returns (h (B,S,H,hd) in q's dtype, (C (B,H,hd,hd), n (B,H,hd), m (B,H)) f32).
    ``state`` (C, n, m) f32 contiguous, None for zeros; it is only read."""
    global launches_step
    _check(q, k, v, gates, state)
    if q.shape[1] > STEP_MAX:
        return mlstm_chunkwise(q, k, v, gates, state)
    h, st, launched = _launch("repro_mlstm_step", "mlstm_step", (_build.DTYPE_CODE[q.dtype],),
                              q, k, v, gates, state)
    launches_step += launched
    return h, st


def mlstm_tf32(
    q: torch.Tensor,       # (B, S, H, hd) f32 or bf16, rows contiguous
    k: torch.Tensor,
    v: torch.Tensor,
    gates: torch.Tensor,   # (B, S, 2H) f32
    state: Optional[Tuple[torch.Tensor, torch.Tensor, torch.Tensor]] = None,
    keep: bool = False,
):
    """The same function as ``mlstm`` on the split-TF32 chunkwise kernel;
    with ``keep`` also what the gradient starts from, a third element."""
    global launches_tf32
    _check(q, k, v, gates, state)
    out, launched = _launch_chunkwise("repro_mlstm", "mlstm_tf32", (_build.DTYPE_CODE[q.dtype],),
                                      q, k, v, gates, state, keep)
    launches_tf32 += launched
    return out


def tc_design(B: int, S: int, H: int, hd: int) -> str:
    """Which design of the tensor-core kernel takes a call of this shape
    (``csrc/mlstm_tc.cu``): "split", a carry pass over C's 64 x 64 tiles
    ((hd / 64)^2 blocks a (b, h)) and then an output pass parallel over
    (chunk, 64 value rows, b·h), or "single", a block per 64 value rows of
    C walking every chunk (hd / 64 blocks a (b, h), one an SM). The split
    runs where the single pass's grid is under TC_SPLIT_BELOW blocks: it
    writes and reads back C at every chunk's start, which the single pass
    keeps on chip, and wins only where the single pass leaves most of the
    card idle: on one H100 at S4096 H4 hd512 (``tools/mlstm_fwd_time.py``,
    PERF.md row 5t) at B1 to B3 (32 to 96 single-pass blocks), not from B4
    (128) up."""
    return "split" if (hd // 64) * B * H < TC_SPLIT_BELOW else "single"


def mlstm_tc(
    q: torch.Tensor,       # (B, S, H, hd) bf16, rows contiguous
    k: torch.Tensor,
    v: torch.Tensor,
    gates: torch.Tensor,   # (B, S, 2H) f32
    state: Optional[Tuple[torch.Tensor, torch.Tensor, torch.Tensor]] = None,
    keep: bool = False,
):
    """The same function as ``mlstm`` on the tensor-core kernel, in the
    design ``tc_design`` picks for the shape; with ``keep`` also what the
    gradient starts from, a third element."""
    return tc_call(tc_design(*q.shape), q, k, v, gates, state, keep)


def tc_call(design: str, q, k, v, gates, state=None, keep: bool = False):
    """``mlstm_tc`` in the given design ("split" or "single"), whatever the
    shape: the model's calls go through ``mlstm_tc``; the checks and timings
    on the card call each design here. The split's carry hands C, n and m
    at each chunk's start to its output pass through the tensors kept for
    the gradient, allocated without ``keep`` too (and then dropped). One
    call counts one launch in ``launches_tc``, whatever it starts."""
    global launches_tc
    if design not in ("split", "single"):
        raise ValueError(f"mlstm_tc: design {design!r} (split or single)")
    _check(q, k, v, gates, state)
    _check_tc(q, k, v)
    if design == "single":
        out, launched = _launch_chunkwise("repro_mlstm_tc", "mlstm_tc", (), q, k, v, gates,
                                          state, keep)
    else:
        kept = _kept(*q.shape, q.device)
        ptrs = (*(t.data_ptr() for t in kept[:3]), kept[3].data_ptr() if keep else None)
        h, st, launched = _launch("repro_mlstm_tc_split", "mlstm_tc", ptrs, q, k, v, gates,
                                  state)
        out = (h, st, kept) if keep else (h, st)
    launches_tc += launched
    return out


def mlstm_chunkwise(q, k, v, gates, state=None, keep: bool = False):
    """The chunkwise kernel ``mlstm`` takes past STEP_MAX (tensor cores where
    ``_tc_takes``, else split TF32), at any S: a forward whose gradient is
    wanted keeps its chunk states, which the step kernel has not."""
    return (mlstm_tc if _tc_takes(q, k, v) else mlstm_tf32)(q, k, v, gates, state, keep)


def mlstm_bwd(
    q: torch.Tensor,       # (B, S, H, hd) f32 or bf16, rows contiguous
    k: torch.Tensor,
    v: torch.Tensor,
    gates: torch.Tensor,   # (B, S, 2H) f32
    h: torch.Tensor,       # (B, S, H, hd) the forward's output, q's dtype
    dh: torch.Tensor,      # (B, S, H, hd) q's dtype
    kept: Kept,            # what the forward kept (``keep=True``)
    final: Optional[Tuple[torch.Tensor, torch.Tensor]] = None,   # the forward's final C, n
    dfinal: Optional[Tuple[Optional[torch.Tensor], ...]] = None,  # their dC, dn and dm
    want_dstate: bool = False,
):
    """The chunkwise mLSTM's gradient on the card. Returns (dq, dk, dv in
    q's dtype, dgates (B, S, 2H) f32, the start state's (dC, dn, dm) f32
    with ``want_dstate``, else None). ``dfinal`` (any of them None: zero)
    needs ``final``."""
    global launches_bwd
    _check(q, k, v, gates, None)
    for name, t in (("h", h), ("dh", dh)):
        if t.shape != q.shape or t.dtype != q.dtype or t.device != q.device or t.stride(3) != 1:
            raise ValueError(f"mlstm_bwd: {name} {t.dtype}{tuple(t.shape)} is not q's "
                             f"{q.dtype}{tuple(q.shape)} with contiguous rows on {q.device}")
    B, S, H, hd = q.shape
    nc = -(-S // CHUNK)
    want = ((B, H, nc, hd, hd), (B, H, nc, hd), (B, H, nc), (B, S, H))
    if any(tuple(t.shape) != w or t.dtype != torch.float32 or not t.is_contiguous()
           or t.device != q.device for t, w in zip(kept, want)):
        raise ValueError(f"mlstm_bwd: kept {[tuple(t.shape) for t in kept]}, expected "
                         f"contiguous f32 {want}")
    dfinal = tuple(dfinal) if dfinal is not None else (None, None, None)
    if any(t is not None for t in dfinal[:2]) and final is None:
        raise ValueError("mlstm_bwd: a final state gradient needs the final state")
    f32 = lambda t: None if t is None else t.float().contiguous()
    dfinal = tuple(f32(t) for t in dfinal)
    final = tuple(f32(t) for t in final) if final is not None else (None, None)
    dev = q.device
    e = lambda *shape, dtype=torch.float32: torch.empty(shape, dtype=dtype, device=dev)
    tiles = hd // bwd_tile(hd)
    dq, dk, dv = e(B, S, H, hd, dtype=q.dtype), e(B, S, H, hd, dtype=q.dtype), e(
        B, S, H, hd, dtype=q.dtype)
    dg = e(B, S, 2 * H)
    dstate = (e(B, H, hd, hd), e(B, H, hd), e(B, H)) if want_dstate else None
    ws = (e(B, H, nc, hd, hd), e(B, H, nc, hd), e(B, S, H), e(B, S, H),
          e(tiles, B, S, H, hd), e(tiles, B, S, H, hd), e(tiles, B, S, H), e(tiles, B, H, nc, 2),
          e(B, H, 4, nc * CHUNK), e(B, H, nc))
    ptr = lambda t: None if t is None else t.data_ptr()
    ins = (q, k, v, gates, h, dh, *kept, *dfinal, *final)
    outs = (dq, dk, dv, dg, *(dstate if dstate is not None else (None,) * 3))
    arr = lambda ts: (ctypes.c_void_p * len(ts))(*(ptr(t) for t in ts))
    strides = (ctypes.c_longlong * 17)(*(st for t in (q, k, v, h, dh) for st in t.stride()[:3]),
                                       *gates.stride()[:2])
    if _build.launch(
            "repro_mlstm_bwd", "mlstm_bwd", dev,
            (ctypes.cast(arr(ins), ctypes.c_void_p), ctypes.cast(arr(outs), ctypes.c_void_p),
             ctypes.cast(arr(ws), ctypes.c_void_p), ctypes.cast(strides, ctypes.c_void_p),
             _build.DTYPE_CODE[q.dtype], B, S, H, hd, _build.STREAM),
            B=B, S=S, H=H, hd=hd, el=q.element_size()):
        launches_bwd += 1
    return dq, dk, dv, dg, dstate
