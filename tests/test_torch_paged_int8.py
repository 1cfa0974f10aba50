"""The int8 pool's paged decode attention on the CPU.

``paged_attention_int8_ref`` (the plain version) against the reference's
int8 gather path (``repro/models/layers.py::decode_attention_paged``: the
block table's pages gathered, ``_dequantize_kv``, ``_paged_attend_gathered``)
and against ``paged_attention_split_ref`` on the pool dequantized by
``_dequantize_kv`` (the CUDA kernel's form); ``ops.paged_decode_attention_int8``
on CPU tensors (the plain version, nothing launched) and on meta tensors (one
int8 call counted at ``int8_cost``'s numbers, nothing launched); and the
wrapper's refusals. The kernel itself runs only on the card, where
``chip_smoke.py::check_paged_int8`` holds it bit for bit against the bf16
and f32 kernel on the dequantized pool.
"""
from __future__ import annotations

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.models import layers as jax_layers
from repro_torch.kernels.paged_attention import kernel, ops
from repro_torch.kernels.paged_attention.ref import (paged_attention_int8_ref,
                                                    paged_attention_split_ref)
from repro_torch.launch.op_cost import OpCost
from repro_torch.models import layers

META = torch.device("meta")
# the reference's kernel tolerances (tests/test_kernels.py)
TOL = {torch.float32: dict(atol=1e-5, rtol=1e-5), torch.bfloat16: dict(atol=2e-2, rtol=2e-2)}
# (B, H, KVH, hd, page_size, max_blocks, lens): the reference's PAGED_CASES,
# then the split's edges (a dead lane, lengths 1, 128 and 129, a table of
# two segments), G=1 with a page of 24 that straddles a segment, and G=4
CASES = [
    (2, 4, 4, 64, 16, 4, [64, 33]),
    (3, 8, 2, 64, 16, 4, [1, 50, 64]),
    (2, 4, 1, 32, 8, 6, [41, 17]),
    (4, 8, 2, 32, 16, 16, [0, 1, 128, 129]),
    (2, 4, 4, 32, 24, 7, [150, 5]),
    (2, 8, 2, 32, 16, 3, [48, 0]),
]
DTYPES = [torch.float32, torch.bfloat16]


def _inputs(B, H, KVH, hd, ps, mb, lens, dtype, seed=0):
    """q, int8 codes and scales (``layers._quantize_kv`` of N(0, 1) pools,
    the scales in q's dtype, as the engine writes them), a block table of
    scattered pages with -1 past each lane's, and the lengths."""
    rng = np.random.RandomState(seed)
    P = B * mb + 1
    q = torch.from_numpy(rng.randn(B, H, hd).astype(np.float32)).to(dtype)
    pools = []
    for _ in range(2):
        codes, scale = layers._quantize_kv(torch.from_numpy(
            rng.randn(P, ps, KVH, hd).astype(np.float32)))
        pools.append((codes, scale.to(dtype)))
    perm = rng.permutation(B * mb)
    table = np.full((B, mb), -1, np.int32)
    for b, n in enumerate(lens):
        used = -(-n // ps)
        table[b, :used] = perm[b * mb: b * mb + used]
    (kc, ks), (vc, vs) = pools
    return (q, kc, vc, ks, vs, torch.from_numpy(table),
            torch.from_numpy(np.asarray(lens, np.int32)))


@jax.jit
def _gather_attend(q, kc, vc, ks, vs, table, lens):
    """The reference's int8 branch of ``decode_attention_paged``
    (``src/repro/models/layers.py:629-638``)."""
    B, H, hd = q.shape
    ps, KVH = kc.shape[1], kc.shape[2]
    tbl = jnp.maximum(table, 0)
    T = tbl.shape[1] * ps
    k_use = jax_layers._dequantize_kv(jnp.take(kc, tbl, axis=0), jnp.take(ks, tbl, axis=0),
                                      q.dtype)
    v_use = jax_layers._dequantize_kv(jnp.take(vc, tbl, axis=0), jnp.take(vs, tbl, axis=0),
                                      q.dtype)
    return jax_layers._paged_attend_gathered(q, k_use.reshape(B, T, KVH, hd),
                                             v_use.reshape(B, T, KVH, hd), lens)


def _jax_gather_path(q, kc, vc, ks, vs, table, lens):
    """``_gather_attend`` on numpy copies of the port's inputs."""
    jd = jnp.bfloat16 if q.dtype == torch.bfloat16 else jnp.float32
    arr = lambda t: (jnp.asarray(t.float().numpy(), jd) if t.is_floating_point()
                     else jnp.asarray(t.numpy()))
    return np.asarray(_gather_attend(*map(arr, (q, kc, vc, ks, vs, table, lens))), np.float32)


def _live(lens):
    return [b for b, n in enumerate(lens) if n > 0]


@pytest.mark.parametrize("dtype", DTYPES, ids=["f32", "bf16"])
@pytest.mark.parametrize("case", CASES, ids=[f"case{i}" for i in range(len(CASES))])
def test_int8_ref_matches_the_reference_gather_path(case, dtype):
    args = _inputs(*case, dtype)
    got = paged_attention_int8_ref(*args)
    assert got.dtype == dtype and got.shape == args[0].shape
    live = _live(case[-1])
    np.testing.assert_allclose(got[live].float().numpy(), _jax_gather_path(*args)[live],
                               **TOL[dtype])


@pytest.mark.parametrize("dtype", DTYPES, ids=["f32", "bf16"])
@pytest.mark.parametrize("case", CASES, ids=[f"case{i}" for i in range(len(CASES))])
def test_int8_ref_matches_the_split_form_on_the_dequantized_pool(case, dtype):
    q, kc, vc, ks, vs, table, lens = args = _inputs(*case, dtype, seed=1)
    kd, vd = layers._dequantize_kv(kc, ks, dtype), layers._dequantize_kv(vc, vs, dtype)
    split = paged_attention_split_ref(q, kd, vd, table, lens)
    live = _live(case[-1])
    np.testing.assert_allclose(paged_attention_int8_ref(*args)[live].float().numpy(),
                               split[live].float().numpy(), **TOL[dtype])
    dead = [b for b, n in enumerate(case[-1]) if n == 0]
    assert torch.all(split[dead] == 0)      # the kernel's form: a dead lane is exact zeros


@pytest.mark.parametrize("dtype", DTYPES, ids=["f32", "bf16"])
def test_int8_ops_on_the_cpu_run_the_plain_version(dtype):
    args = _inputs(*CASES[3], dtype)
    counts = lambda: (kernel.launches_int8_tc, kernel.launches_int8_fma,
                      kernel.launches_tc, kernel.launches_fma)
    before = counts()
    assert torch.equal(ops.paged_decode_attention_int8(*args), paged_attention_int8_ref(*args))
    assert counts() == before
    with pytest.raises(ValueError, match="CUDA"):
        kernel.paged_attention_int8(*args)


@pytest.mark.parametrize("dtype", DTYPES, ids=["f32", "bf16"])
def test_int8_ops_on_meta_count_one_call_at_int8_cost(dtype):
    B, H, KVH, hd, ps, mb, lens = CASES[1]
    args = [t.to(META) for t in _inputs(B, H, KVH, hd, ps, mb, lens, dtype)]
    counts = (kernel.launches_int8_tc, kernel.launches_int8_fma)
    with OpCost() as cost:
        out = ops.paged_decode_attention_int8(*args)
    assert out.device == META and out.shape == (B, H, hd) and out.dtype == dtype
    assert (kernel.launches_int8_tc, kernel.launches_int8_fma) == counts
    variant = "tc" if dtype == torch.bfloat16 else "fma"
    assert cost.kernel_calls == {f"paged_attention_int8_{variant}": 1}
    el = torch.finfo(dtype).bits // 8
    # the meta route counts every slot of the table (it has no lengths to read)
    flops, nbytes = ops.int8_cost(B, H, KVH, hd, tokens=B * mb * ps, pages=B * mb, el=el)
    assert cost.bytes == nbytes
    assert cost.flops_by_dtype == {"bf16" if variant == "tc" else "f32": flops}
    # an int8 element is one byte, its row's scale el bytes, against el a value
    assert nbytes < ops.cost(B, H, KVH, hd, B * mb * ps, B * mb, el=el)[1]


def _meta(args):
    return [t.to(META) for t in args]


def _swap(args, i, t):
    args = list(args)
    args[i] = t
    return args


@pytest.mark.parametrize("what", [
    "codes_bf16", "codes_f32", "scale_dtype", "q_f16", "scale_shape", "v_shape", "hd_mismatch",
    "group_3", "head_dim_48", "table_int64", "lanes",
])
def test_int8_kernel_refuses_what_it_does_not_take(what):
    q, kc, vc, ks, vs, table, lens = args = _meta(_inputs(*CASES[1], torch.bfloat16))
    bad = {
        "codes_bf16": lambda: _swap(args, 1, kc.to(torch.bfloat16)),
        "codes_f32": lambda: _swap(_swap(args, 1, kc.float()), 2, vc.float()),
        "scale_dtype": lambda: _swap(args, 3, ks.float()),
        "q_f16": lambda: _swap(_swap(_swap(args, 0, q.half()), 3, ks.half()), 4, vs.half()),
        "scale_shape": lambda: _swap(args, 3, ks[..., 0]),
        "v_shape": lambda: _swap(args, 2, vc[:-1]),
        "hd_mismatch": lambda: _swap(args, 0, q[..., :32]),
        "group_3": lambda: _swap(args, 0, torch.empty((3, 6, 64), dtype=q.dtype,
                                                      device=META)),
        "head_dim_48": lambda: [torch.empty((3, 8, 48), dtype=q.dtype, device=META),
                                *(t[..., :48] for t in (kc, vc)), ks, vs, table, lens],
        "table_int64": lambda: _swap(args, 5, table.long()),
        "lanes": lambda: _swap(args, 6, lens[:2]),
    }[what]()
    with pytest.raises(ValueError, match="paged_attention kernel"):
        kernel.paged_attention_int8(*bad)
    # the bf16 and f32 entry refuses an int8 pool
    with pytest.raises(ValueError, match="paged_attention_int8"):
        kernel.paged_attention(q, kc, vc, table, lens)
