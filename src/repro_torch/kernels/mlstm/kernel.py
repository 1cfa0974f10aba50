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
inputs, for the checks on the card.
"""
from __future__ import annotations

from typing import Optional, Tuple

import torch

from repro_torch.kernels import _build

launches_tc = 0     # kernel launches since the last reset (plain ints), by variant
launches_tf32 = 0
launches_step = 0

MAX_HEAD_DIM = 512   # the kernels keep a tile of C's rows (rows x hd f32) on chip
STEP_MAX = 8         # up to this many timesteps run in one pass over C


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


def _launch(fn, what, dtype_args, q, k, v, gates, state):
    """Allocates h and the final state, launches ``fn`` and raises on a CUDA error."""
    B, S, H, hd = q.shape
    h = torch.empty((B, S, H, hd), dtype=q.dtype, device=q.device)
    C = torch.empty((B, H, hd, hd), dtype=torch.float32, device=q.device)
    n = torch.empty((B, H, hd), dtype=torch.float32, device=q.device)
    m = torch.empty((B, H), dtype=torch.float32, device=q.device)
    C0, n0, m0 = (t.data_ptr() for t in state) if state is not None else (None, None, None)
    with torch.cuda.device(q.device):
        err = fn(
            q.data_ptr(), k.data_ptr(), v.data_ptr(), gates.data_ptr(), C0, n0, m0,
            h.data_ptr(), C.data_ptr(), n.data_ptr(), m.data_ptr(),
            *dtype_args, B, S, H, hd,
            *q.stride()[:3], *k.stride()[:3], *v.stride()[:3], *h.stride()[:3],
            *gates.stride()[:2], torch.cuda.current_stream(q.device).cuda_stream,
        )
    _build.check(err, what)
    return h, (C, n, m)


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
        return (mlstm_tc if _tc_takes(q, k, v) else mlstm_tf32)(q, k, v, gates, state)
    out = _launch(_build.load().repro_mlstm_step, "mlstm (step)",
                  (_build.DTYPE_CODE[q.dtype],), q, k, v, gates, state)
    launches_step += 1
    return out


def mlstm_tf32(
    q: torch.Tensor,       # (B, S, H, hd) f32 or bf16, rows contiguous
    k: torch.Tensor,
    v: torch.Tensor,
    gates: torch.Tensor,   # (B, S, 2H) f32
    state: Optional[Tuple[torch.Tensor, torch.Tensor, torch.Tensor]] = None,
) -> Tuple[torch.Tensor, Tuple[torch.Tensor, torch.Tensor, torch.Tensor]]:
    """The same function as ``mlstm`` on the split-TF32 chunkwise kernel."""
    global launches_tf32
    _check(q, k, v, gates, state)
    out = _launch(_build.load().repro_mlstm, "mlstm (tf32)", (_build.DTYPE_CODE[q.dtype],),
                  q, k, v, gates, state)
    launches_tf32 += 1
    return out


def mlstm_tc(
    q: torch.Tensor,       # (B, S, H, hd) bf16, rows contiguous
    k: torch.Tensor,
    v: torch.Tensor,
    gates: torch.Tensor,   # (B, S, 2H) f32
    state: Optional[Tuple[torch.Tensor, torch.Tensor, torch.Tensor]] = None,
) -> Tuple[torch.Tensor, Tuple[torch.Tensor, torch.Tensor, torch.Tensor]]:
    """The same function as ``mlstm`` on the tensor-core kernel."""
    global launches_tc
    _check(q, k, v, gates, state)
    _check_tc(q, k, v)
    out = _launch(_build.load().repro_mlstm_tc, "mlstm (tc)", (), q, k, v, gates, state)
    launches_tc += 1
    return out
