"""The paged kernel's split-and-merge algorithm, as its plain form
``paged_attention_split_ref``, against the JAX package on the CPU.

The CUDA kernel splits each lane's positions into segments of 128
positions, computes a partial (m, l, acc) per segment and merges the live
segments in order. Its plain form is held against the JAX
``paged_attention_ref`` and the Pallas ``paged_decode_attention`` in
interpret mode on the PAGED_CASES rows of ``tests/test_kernels.py``
(copied), at the kernel's segment and at segments of 8 and 16 positions
(so that these short lanes span several), and on the edges of the split
at the kernel's segment: lengths 0 and 1, exactly one segment, one segment
plus one position, every lane dead, and pages that span segments. Inputs
are made with numpy from a seed; f32 at 1e-5, bf16 at the JAX test's 2e-2.
"""
from pathlib import Path

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels.paged_attention import paged_attention_ref as jax_paged_ref
from repro.kernels.paged_attention import paged_decode_attention as jax_paged
from repro_torch.kernels.paged_attention import paged_attention_ref, paged_attention_split_ref
from repro_torch.kernels.paged_attention.ref import SEGMENT_POSITIONS

F32, BF16 = "float32", "bfloat16"

# tests/test_kernels.py PAGED_CASES: B, H, KVH, hd, page_size, max_blocks, lens, dtype
PAGED_CASES = [
    (2, 4, 4, 64, 16, 4, [64, 33], F32),
    (3, 8, 2, 64, 16, 4, [1, 50, 64], F32),
    (2, 4, 1, 32, 8, 6, [41, 17], F32),
    (2, 4, 2, 64, 16, 4, [64, 7], BF16),
]
# B, H, KVH, hd, page_size, max_blocks, lens: the split's edges at the
# kernel's segment of 128 positions
EDGE_CASES = [
    ("len 0 beside live lanes", 3, 4, 2, 32, 16, 17, [0, 20, 129]),
    ("len 1", 2, 4, 2, 32, 16, 17, [1, 130]),
    ("exactly one and two segments", 2, 4, 2, 32, 16, 17, [128, 256]),
    ("one segment plus one position", 2, 4, 2, 32, 16, 17, [129, 257]),
    ("every lane dead", 3, 4, 2, 32, 16, 17, [0, 0, 0]),
    ("page 8, one segment and one more", 2, 4, 2, 32, 8, 33, [128, 129]),
    ("page 24 straddles the segments", 2, 8, 2, 64, 24, 12, [128, 150]),
    ("page 256 holds two segments", 2, 4, 2, 32, 256, 2, [129, 300]),
]


def tol(dtype):
    return dict(atol=2e-2, rtol=2e-2) if dtype == BF16 else dict(atol=1e-5, rtol=1e-5)


def _inputs(B, H, KVH, hd, ps, mb, lens, dtype, seed=0):
    """A random pool and a block table scattering each lane's pages through
    a permutation, unassigned entries -1; numpy arrays and their JAX and
    torch twins with the same bits."""
    rng = np.random.RandomState(seed)
    num_pages = B * mb + 1
    arrs = [rng.randn(B, H, hd), rng.randn(num_pages, ps, KVH, hd),
            rng.randn(num_pages, ps, KVH, hd)]
    arrs = [x.astype(np.float32) for x in arrs]
    perm = rng.permutation(B * mb)
    table = np.full((B, mb), -1, np.int32)
    for b, n in enumerate(lens):
        used = -(-n // ps)
        table[b, :used] = perm[b * mb: b * mb + used]
    jx = [jnp.asarray(x, jnp.dtype(dtype)) for x in arrs]
    tx = [torch.from_numpy(x).to(getattr(torch, dtype)) for x in arrs]
    sl = np.asarray(lens, np.int32)
    return jx + [jnp.asarray(table), jnp.asarray(sl)], tx + [torch.from_numpy(table),
                                                             torch.from_numpy(sl)]


def _close(jax_out, torch_out, dtype):
    np.testing.assert_allclose(torch_out.float().numpy(), np.asarray(jax_out, np.float32),
                               **tol(dtype))


def test_segment_matches_the_kernel_source():
    src = Path(__file__).resolve().parents[1] / "src/repro_torch/csrc/paged_attention.cu"
    assert f"constexpr int SEG = {SEGMENT_POSITIONS};" in src.read_text()


@pytest.mark.parametrize("segment", [SEGMENT_POSITIONS, 8, 16])
@pytest.mark.parametrize("B,H,KVH,hd,ps,mb,lens,dtype", PAGED_CASES)
def test_split_matches_jax_ref(B, H, KVH, hd, ps, mb, lens, dtype, segment):
    jx, tx = _inputs(B, H, KVH, hd, ps, mb, lens, dtype)
    out = paged_attention_split_ref(*tx, segment=segment)
    assert out.dtype == getattr(torch, dtype) and tuple(out.shape) == (B, H, hd)
    _close(jax_paged_ref(*jx), out, dtype)


@pytest.mark.parametrize("row", range(len(PAGED_CASES)))
def test_split_matches_pallas_interpret(row):
    B, H, KVH, hd, ps, mb, lens, dtype = PAGED_CASES[row]
    jx, tx = _inputs(B, H, KVH, hd, ps, mb, lens, dtype, seed=3 + row)
    _close(jax_paged(*jx, interpret=True), paged_attention_split_ref(*tx, segment=8), dtype)


@pytest.mark.parametrize("name,B,H,KVH,hd,ps,mb,lens", EDGE_CASES,
                         ids=[c[0] for c in EDGE_CASES])
def test_split_edges(name, B, H, KVH, hd, ps, mb, lens):
    jx, tx = _inputs(B, H, KVH, hd, ps, mb, lens, F32, seed=len(name))
    out = paged_attention_split_ref(*tx)
    for b, n in enumerate(lens):
        if n == 0:
            assert torch.all(out[b] == 0.0), f"dead lane {b} is not exact zeros"
    # the gather form zeroes dead lanes itself; the Pallas kernel's finalize does too
    _close(jax_paged_ref(*jx), out, F32)
    _close(jax_paged(*jx, interpret=True), out, F32)
    np.testing.assert_allclose(out.numpy(), paged_attention_ref(*tx).numpy(), **tol(F32))


def test_split_dead_lane_leaves_neighbours_bit_identical():
    _, tx = _inputs(3, 4, 2, 32, 8, 6, [40, 17, 25], F32)
    q, kp, vp, table, sl = tx
    dead = sl.clone()
    dead[1] = 0
    full = paged_attention_split_ref(q, kp, vp, table, sl, segment=16)
    out = paged_attention_split_ref(q, kp, vp, table, dead, segment=16)
    assert torch.all(out[1] == 0.0)
    assert torch.equal(out[0], full[0]) and torch.equal(out[2], full[2])
