"""The PyTorch port's attention kernels on the CPU: their plain versions
against the JAX oracles (``ref.py``) and the Pallas kernels in interpret
mode, on the reference's case tables, plus the wrappers' CPU dispatch.

The CUDA kernels themselves cannot run here; ``chip_smoke.py`` holds each
against these plain versions on the card. Inputs are made with numpy from
a seed and handed to both stacks. Tolerances: f32 atol=rtol=1e-4 (XLA and
torch sum in different orders); bf16 the repository's 2e-2.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels.flash_attention import attention_ref as jax_attention_ref
from repro.kernels.flash_attention import flash_attention as jax_flash
from repro.kernels.paged_attention import paged_attention_ref as jax_paged_ref
from repro.kernels.paged_attention import paged_decode_attention as jax_paged
from repro_torch.kernels.flash_attention import attention_ref, flash_attention
from repro_torch.kernels.flash_attention import kernel as flash_kernel
from repro_torch.kernels.paged_attention import paged_attention_ref, paged_decode_attention
from repro_torch.kernels.paged_attention import kernel as paged_kernel

F32, BF16 = "float32", "bfloat16"


def tol(dtype):
    return dict(atol=2e-2, rtol=2e-2) if dtype == BF16 else dict(atol=1e-4, rtol=1e-4)


def both(x: np.ndarray, dtype: str):
    """One numpy array as a JAX array and a torch tensor with the same bits."""
    if x.dtype.kind in "iu":
        return jnp.asarray(x), torch.from_numpy(x)
    return jnp.asarray(x, jnp.dtype(dtype)), torch.from_numpy(x).to(getattr(torch, dtype))


def close(jax_out, torch_out, dtype):
    np.testing.assert_allclose(
        torch_out.float().numpy(), np.asarray(jax_out, np.float32), **tol(dtype)
    )


# ---------------------------------------------------------------------------
# flash attention
# ---------------------------------------------------------------------------

# tests/test_kernels.py FLASH_CASES: B, S, H, KVH, hd, causal, window, dtype;
# then the rows that hold the bf16 tensor-core kernel to each of its features
# (hd 32, a window, S not a multiple of 128), in both dtypes where the JAX
# table has only one. chip_smoke.py holds the kernels to the same table.
FLASH_CASES = [
    (2, 256, 4, 4, 64, True, 0, F32),
    (1, 256, 8, 2, 64, True, 0, F32),
    (2, 128, 4, 1, 32, True, 64, F32),
    (1, 384, 4, 4, 128, True, 0, F32),
    (1, 256, 4, 2, 64, True, 0, BF16),
    (2, 128, 2, 2, 128, True, 32, BF16),
    (2, 128, 4, 1, 32, True, 64, BF16),      # hd 32 (64-byte swizzle) with a window
    (1, 200, 4, 2, 32, True, 48, F32),       # ragged against 128-row tiles, window
    (1, 200, 4, 2, 32, True, 48, BF16),
    (2, 333, 8, 2, 128, True, 0, F32),       # ragged, GQA 4:1
    (2, 333, 8, 2, 128, True, 0, BF16),
]
# B, Sq, Skv, H, KVH, hd, causal, window, q_offset: cases beyond the square
# causal ones, run in both dtypes
FLASH_EXTRA_CASES = [
    (1, 64, 192, 4, 2, 64, True, 0, 128),    # q_offset: q rows after a prefix
    (2, 100, 100, 4, 2, 64, False, 0, 0),    # non-causal, ragged length
]


def _flash_inputs(B, Sq, Skv, H, KVH, hd, dtype, seed=0):
    rng = np.random.RandomState(seed)
    q = rng.randn(B, Sq, H, hd).astype(np.float32)
    k = rng.randn(B, Skv, KVH, hd).astype(np.float32)
    v = rng.randn(B, Skv, KVH, hd).astype(np.float32)
    return [both(x, dtype) for x in (q, k, v)]


@pytest.mark.parametrize(
    "B,Sq,Skv,H,KVH,hd,causal,window,q_offset,dtype",
    [(B, S, S, H, KVH, hd, c, w, 0, dt) for B, S, H, KVH, hd, c, w, dt in FLASH_CASES]
    + [(*case, dt) for dt in (F32, BF16) for case in FLASH_EXTRA_CASES],
)
def test_flash_plain_matches_jax_ref(B, Sq, Skv, H, KVH, hd, causal, window, q_offset, dtype):
    (qj, qt), (kj, kt), (vj, vt) = _flash_inputs(B, Sq, Skv, H, KVH, hd, dtype)
    kw = dict(causal=causal, window=window, q_offset=q_offset)
    close(jax_attention_ref(qj, kj, vj, **kw), attention_ref(qt, kt, vt, **kw), dtype)


@pytest.mark.parametrize("row", [1, 5])
def test_flash_plain_matches_pallas_interpret(row):
    B, S, H, KVH, hd, causal, window, dtype = FLASH_CASES[row]
    (qj, qt), (kj, kt), (vj, vt) = _flash_inputs(B, S, S, H, KVH, hd, dtype, seed=row)
    out = jax_flash(qj, kj, vj, causal, window, 0, 128, 128, True)
    close(out, attention_ref(qt, kt, vt, causal=causal, window=window), dtype)


# ---------------------------------------------------------------------------
# paged decode attention
# ---------------------------------------------------------------------------

# tests/test_kernels.py PAGED_CASES: B, H, KVH, hd, page_size, max_blocks, lens, dtype
PAGED_CASES = [
    (2, 4, 4, 64, 16, 4, [64, 33], F32),
    (3, 8, 2, 64, 16, 4, [1, 50, 64], F32),
    (2, 4, 1, 32, 8, 6, [41, 17], F32),
    (2, 4, 2, 64, 16, 4, [64, 7], BF16),
]


def _paged_inputs(B, H, KVH, hd, ps, mb, lens, dtype, seed=0):
    """Random pool + a block table scattering each lane's pages through a
    permutation, unassigned tail entries left at -1 (the reference's case)."""
    rng = np.random.RandomState(seed)
    num_pages = B * mb + 1
    q = rng.randn(B, H, hd).astype(np.float32)
    kp = rng.randn(num_pages, ps, KVH, hd).astype(np.float32)
    vp = rng.randn(num_pages, ps, KVH, hd).astype(np.float32)
    perm = rng.permutation(B * mb)
    table = np.full((B, mb), -1, np.int32)
    for b, n in enumerate(lens):
        used = -(-n // ps)
        table[b, :used] = perm[b * mb: b * mb + used]
    sl = np.asarray(lens, np.int32)
    return [both(x, dtype) for x in (q, kp, vp, table, sl)]


def _split(pairs):
    return [p[0] for p in pairs], [p[1] for p in pairs]


@pytest.mark.parametrize("B,H,KVH,hd,ps,mb,lens,dtype", PAGED_CASES)
def test_paged_plain_matches_jax_ref(B, H, KVH, hd, ps, mb, lens, dtype):
    jx, tx = _split(_paged_inputs(B, H, KVH, hd, ps, mb, lens, dtype))
    close(jax_paged_ref(*jx), paged_attention_ref(*tx), dtype)


def test_paged_plain_matches_pallas_interpret():
    B, H, KVH, hd, ps, mb, lens, dtype = PAGED_CASES[1]
    jx, tx = _split(_paged_inputs(B, H, KVH, hd, ps, mb, lens, dtype, seed=3))
    close(jax_paged(*jx, interpret=True), paged_attention_ref(*tx), dtype)


def test_paged_dead_lane_is_zero_and_isolated():
    """A seq_len-0 lane gives exact zeros and leaves live lanes bit-unchanged."""
    jx, tx = _split(_paged_inputs(3, 4, 2, 32, 16, 3, [40, 17, 25], F32))
    q, kp, vp, table, sl = tx
    dead = sl.clone()
    dead[1] = 0
    out = paged_attention_ref(q, kp, vp, table, dead)
    full = paged_attention_ref(q, kp, vp, table, sl)
    assert torch.all(out[1] == 0.0)
    assert torch.equal(out[0], full[0]) and torch.equal(out[2], full[2])
    jdead = jx[4].at[1].set(0)
    close(jax_paged(*jx[:4], jdead, interpret=True), out, F32)


# ---------------------------------------------------------------------------
# wrappers: CPU dispatch, and the kernel path refuses CPU tensors
# ---------------------------------------------------------------------------

def test_flash_ops_cpu_dispatch_runs_plain_version():
    _, tx = _split(_flash_inputs(1, 40, 40, 4, 2, 32, F32))
    counts = lambda: (flash_kernel.launches_tc, flash_kernel.launches_tf32)
    before = counts()
    out = flash_attention(*tx, True, 0, 0)
    assert torch.equal(out, attention_ref(*tx, causal=True))
    assert counts() == before
    with pytest.raises(ValueError, match="CUDA"):
        flash_kernel.flash_attention_fwd(*tx)


def test_paged_ops_cpu_dispatch_runs_plain_version():
    _, tx = _split(_paged_inputs(2, 4, 2, 32, 16, 3, [20, 9], F32))
    counts = lambda: (paged_kernel.launches_tc, paged_kernel.launches_fma)
    before = counts()
    assert torch.equal(paged_decode_attention(*tx), paged_attention_ref(*tx))
    assert counts() == before
    with pytest.raises(ValueError, match="CUDA"):
        paged_kernel.paged_attention(*tx)
