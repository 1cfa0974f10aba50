"""The port's flash-attention backward on the CPU: ``attention_bwd_ref``
(the plain version the CUDA kernels are held against) against the JAX
package's Pallas backward kernels in interpret mode and against autograd
of ``attention_ref``; the autograd Function's CPU path; and the kernel
wrapper refusing CPU tensors.

The CUDA kernels themselves cannot run here; ``chip_smoke.py`` holds
them against ``attention_bwd_ref`` on the card. Inputs are made with numpy
from a seed and handed to both stacks. Tolerance: f32 atol=rtol=1e-4 (the
JAX test's own, for sums taken in different orders).
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels.flash_attention import attention_ref as jax_attention_ref
from repro.kernels.flash_attention.kernel_bwd import flash_attention_bwd as jax_bwd
from repro_torch.kernels.flash_attention import (
    attention_bwd_ref,
    attention_fwd_ref,
    attention_ref,
    flash_attention,
)
from repro_torch.kernels.flash_attention import kernel_bwd

TOL = dict(atol=1e-4, rtol=1e-4)

# tests/test_kernels.py FLASH_BWD_CASES: B, S, H, KVH, hd, window
FLASH_BWD_CASES = [
    (1, 128, 2, 2, 32, 0),
    (1, 128, 4, 2, 32, 0),      # GQA: dk/dv accumulate over the group dim
    (1, 128, 4, 1, 64, 32),     # MQA + sliding window
    (1, 192, 2, 2, 32, 0),      # ragged against 128-row blocks
]
# (B, Sq, Skv, H, KVH, hd, causal, window, q_offset): every case the Function takes
FUNCTION_CASES = [
    (B, S, S, H, KVH, hd, True, w, 0) for B, S, H, KVH, hd, w in FLASH_BWD_CASES
] + [
    (1, 64, 192, 4, 2, 64, True, 0, 128),    # q rows after a prefix
    (2, 100, 100, 4, 2, 64, False, 0, 0),    # non-causal, ragged length
]


# B, Sq, Skv, H, KVH, hd, causal, window, q_offset: the cases that hold the
# bf16 tensor-core dk/dv kernel to each of its features on the card
# (chip_smoke.py runs the same shapes): hd 32, 64 and 128, a window, GQA,
# q_offset, non-causal ragged S, S not a multiple of 128
BF16_CASES = [
    (1, 128, 128, 4, 2, 32, True, 0, 0),
    (1, 128, 128, 4, 1, 64, True, 32, 0),
    (1, 256, 256, 4, 2, 64, True, 0, 0),
    (1, 64, 192, 4, 2, 64, True, 0, 128),
    (2, 100, 100, 4, 2, 64, False, 0, 0),
    (1, 200, 200, 4, 2, 32, True, 48, 0),
    (2, 333, 333, 8, 2, 128, True, 0, 0),
]
BF16_TOL = dict(atol=2e-2, rtol=2e-2)   # the repository's bf16 kernel tolerance


def _inputs(B, Sq, Skv, H, KVH, hd, seed=0):
    rng = np.random.RandomState(seed)
    shapes = [(B, Sq, H, hd), (B, Skv, KVH, hd), (B, Skv, KVH, hd), (B, Sq, H, hd)]
    return [torch.from_numpy(rng.randn(*s).astype(np.float32)) for s in shapes]


def _autograd(q, k, v, do, fn, **kw):
    leaves = [t.clone().requires_grad_() for t in (q, k, v)]
    fn(*leaves, **kw).backward(do)
    return [t.grad for t in leaves]


def _close(got, want):
    for g, w in zip(got, want):
        np.testing.assert_allclose(g.float().numpy(), np.asarray(w, np.float32), **TOL)


@pytest.mark.parametrize("B,S,H,KVH,hd,window", FLASH_BWD_CASES)
def test_bwd_plain_matches_pallas_interpret(B, S, H, KVH, hd, window):
    q, k, v, do = _inputs(B, S, S, H, KVH, hd, seed=S + H + window)
    kw = dict(causal=True, window=window)
    o, lse = attention_fwd_ref(q, k, v, **kw)
    head_major = lambda t: jnp.asarray(t.transpose(1, 2).numpy())
    dq, dk, dv = jax_bwd(
        head_major(q), head_major(k), head_major(v), head_major(o), jnp.asarray(lse.numpy()),
        head_major(do), **kw, block_q=64, block_k=64, interpret=True)
    want = [np.moveaxis(np.asarray(g), 1, 2) for g in (dq, dk, dv)]
    _close(attention_bwd_ref(q, k, v, o, lse, do, **kw), want)


@pytest.mark.parametrize("B,Sq,Skv,H,KVH,hd,causal,window,q_offset", FUNCTION_CASES)
def test_bwd_plain_matches_autograd_of_attention_ref(B, Sq, Skv, H, KVH, hd, causal, window,
                                                     q_offset):
    q, k, v, do = _inputs(B, Sq, Skv, H, KVH, hd, seed=1)
    kw = dict(causal=causal, window=window, q_offset=q_offset)
    o, lse = attention_fwd_ref(q, k, v, **kw)
    assert torch.equal(o, attention_ref(q, k, v, **kw))
    want = _autograd(q, k, v, do, attention_ref, **kw)
    _close(attention_bwd_ref(q, k, v, o, lse, do, **kw), want)


@pytest.mark.parametrize("B,Sq,Skv,H,KVH,hd,causal,window,q_offset", FUNCTION_CASES)
def test_function_cpu_path_matches_autograd_of_attention_ref(B, Sq, Skv, H, KVH, hd, causal,
                                                             window, q_offset):
    q, k, v, do = _inputs(B, Sq, Skv, H, KVH, hd, seed=2)
    kw = dict(causal=causal, window=window, q_offset=q_offset)
    counts = lambda: (kernel_bwd.launches_dkdv_tc, kernel_bwd.launches_dkdv_fma,
                      kernel_bwd.launches_dq)
    before = counts()
    got = _autograd(q, k, v, do, lambda *t, **a: flash_attention(*t, causal, window, q_offset))
    _close(got, _autograd(q, k, v, do, attention_ref, **kw))
    assert counts() == before


@pytest.mark.parametrize("B,Sq,Skv,H,KVH,hd,causal,window,q_offset", BF16_CASES)
def test_bwd_plain_matches_jax_autograd_bf16(B, Sq, Skv, H, KVH, hd, causal, window, q_offset):
    """bf16 inputs: ``attention_bwd_ref`` (f32 math, bf16 gradients) against
    JAX's vjp of its ``attention_ref`` on the same bits."""
    q, k, v, do = (t.to(torch.bfloat16) for t in _inputs(B, Sq, Skv, H, KVH, hd, seed=3))
    kw = dict(causal=causal, window=window, q_offset=q_offset)
    o, lse = attention_fwd_ref(q, k, v, **kw)
    to_jax = lambda t: jnp.asarray(t.float().numpy(), jnp.bfloat16)
    _, vjp = jax.vjp(lambda *a: jax_attention_ref(*a, **kw), to_jax(q), to_jax(k), to_jax(v))
    want = vjp(to_jax(do))
    got = attention_bwd_ref(q, k, v, o, lse, do, **kw)
    for g, w in zip(got, want):
        assert g.dtype == torch.bfloat16 and w.dtype == jnp.bfloat16
        np.testing.assert_allclose(g.float().numpy(), np.asarray(w, np.float32), **BF16_TOL)


def test_bwd_kernel_wrapper_refuses_cpu_tensors():
    q, k, v, do = _inputs(1, 40, 40, 4, 2, 32)
    o, lse = attention_fwd_ref(q, k, v)
    delta = (do * o).sum(-1).transpose(1, 2).contiguous()
    with pytest.raises(ValueError, match="CUDA"):
        kernel_bwd.flash_attention_bwd(q, k, v, o, lse, do)
    with pytest.raises(ValueError, match="CUDA"):
        kernel_bwd.flash_attention_bwd_dkdv(q, k, v, do, lse, delta)
    with pytest.raises(ValueError, match="CUDA"):
        kernel_bwd.flash_attention_bwd_dq(q, k, v, do, lse, delta)
