"""The arithmetic of the f32 flash backward's CUDA kernels, emulated on the
CPU: every product (s = q k^T, dp = do v^T, dv = p^T do, dk = ds^T q,
dq = ds k) as split TF32 (3xTF32). Each f32 operand x is split into
hi = rna(x) and lo = rna(x - hi), rna being ``cvt.rna.tf32.f32`` (round
the low 13 of 23 mantissa bits to nearest, ties away from zero), and
a . b is taken as (a_lo b_hi + a_hi b_lo) + a_hi b_hi in f32.

The emulation lives here only; the package's plain version stays
``attention_bwd_ref``. It is held against the JAX package's Pallas backward
in interpret mode and against an f64 reference at hd 128 and hd 256
(S 512), at the JAX test's tolerance (atol = rtol = 1e-4); one TF32 product
per product, without the split, misses that tolerance.

    PYTHONPATH=src python tests/test_torch_flash_bwd_tf32.py

prints, at three of the port's f32 training shapes, the worst error of
plain f32, the split and one TF32 product against the f64 reference, as a
fraction of the tolerance's limit.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels.flash_attention.kernel_bwd import flash_attention_bwd as jax_bwd
from repro_torch.kernels.flash_attention import attention_bwd_ref, attention_fwd_ref
from repro_torch.kernels.flash_attention.ref import _mask

TOL = dict(atol=1e-4, rtol=1e-4)      # FLASH_BWD_F32_TOL, the JAX test's own

# (B, Sq, Skv, H, KVH, hd, causal, window, q_offset): tests/test_torch_flash_bwd.py
# FUNCTION_CASES (its FLASH_BWD_CASES, causal from position 0, then q rows
# after a prefix and a non-causal ragged length)
FUNCTION_CASES = [
    (1, 128, 128, 2, 2, 32, True, 0, 0),
    (1, 128, 128, 4, 2, 32, True, 0, 0),
    (1, 128, 128, 4, 1, 64, True, 32, 0),
    (1, 192, 192, 2, 2, 32, True, 0, 0),
    (1, 64, 192, 4, 2, 64, True, 0, 128),
    (2, 100, 100, 4, 2, 64, False, 0, 0),
]
# (B, S, H, KVH, hd): against the f64 reference; at the first the single
# TF32 product misses TOL (worst error 22.0x the limit here)
F64_CASES = [
    (1, 512, 4, 2, 128),
    (1, 512, 2, 2, 256),
]


def rna(x: torch.Tensor) -> torch.Tensor:
    """cvt.rna.tf32.f32 of an f32 tensor, as f32: add half of the 13 dropped
    bits' unit to the magnitude's bits, then clear them (the sign bit is
    apart, so the rounding is of the magnitude: ties away from zero)."""
    bits = x.contiguous().view(torch.int32)
    return ((bits + 0x1000) & -0x2000).view(torch.float32)


def split(x: torch.Tensor):
    hi = rna(x)
    return hi, rna(x - hi)


def mm_split(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """a @ b (f32) as split TF32: three products of TF32 values (each exact in
    f32), the two small terms first."""
    (ah, al), (bh, bl) = split(a), split(b)
    return (al @ bh + ah @ bl) + ah @ bh


def mm_tf32(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """a @ b (f32) as one TF32 product: each operand rounded once."""
    return rna(a) @ rna(b)


def mm_f32(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    return a @ b


def bwd(q, k, v, o, lse, do, mm, *, causal=True, window=0, q_offset=0, dtype=torch.float32):
    """(dq, dk, dv) by the kernels' formula (``attention_bwd_ref``'s) with
    every product taken by ``mm``, in ``dtype``: p = exp(s scale - lse)
    masked to 0, dv = p^T do, ds = p (dp - delta) scale, dk = ds^T q,
    dq = ds k; dk and dv sum over the G query heads of each kv head."""
    B, Sq, H, hd = q.shape
    Skv, KVH = k.shape[1], k.shape[2]
    G = H // KVH
    scale = float(1.0 / np.sqrt(hd))
    heads = lambda t: t.to(dtype).transpose(1, 2)                      # (B, heads, S, hd)
    qh, doh, oh = heads(q), heads(do), heads(o)
    kh = heads(k).repeat_interleave(G, dim=1)
    vh = heads(v).repeat_interleave(G, dim=1)
    lse_r = lse.to(dtype)                                              # (B, H, Sq, 1)
    delta = (doh * oh).sum(-1, keepdim=True)
    mask = _mask(Sq, Skv, causal, window, q_offset, q.device)
    p = torch.where(mask, torch.exp(mm(qh, kh.transpose(-1, -2)) * scale - lse_r), 0.0)
    ds = p * (mm(doh, vh.transpose(-1, -2)) - delta) * scale
    group = lambda t: t.reshape(B, KVH, G, Skv, hd).sum(2).transpose(1, 2)
    dv = group(mm(p.transpose(-1, -2), doh))
    dk = group(mm(ds.transpose(-1, -2), qh))
    dq = mm(ds, kh).transpose(1, 2)
    return dq, dk, dv


def _inputs(B, Sq, Skv, H, KVH, hd, seed):
    rng = np.random.RandomState(seed)
    shapes = [(B, Sq, H, hd), (B, Skv, KVH, hd), (B, Skv, KVH, hd), (B, Sq, H, hd)]
    return [torch.from_numpy(rng.randn(*s).astype(np.float32)) for s in shapes]


def _worst(got, want) -> float:
    """The largest |got - want| / (atol + rtol |want|) over dq, dk and dv:
    at most 1 where TOL holds."""
    limit = lambda w: TOL["atol"] + TOL["rtol"] * w.double().abs()
    return max(float(((g.double() - w.double()).abs() / limit(w)).max())
               for g, w in zip(got, want))


def _f64_case(B, S, H, KVH, hd, seed=7):
    q, k, v, do = _inputs(B, S, S, H, KVH, hd, seed)
    o, lse = attention_fwd_ref(q, k, v)
    ref = bwd(q, k, v, o, lse, do, mm_f32, dtype=torch.float64)
    return (q, k, v, o, lse, do), ref


def test_rna_rounds_to_nearest_ties_away():
    """``rna`` against the rounding written out: |x| to the nearest multiple
    of 2^(e - 10) (e = x's exponent), a tie away from zero."""
    rng = np.random.RandomState(0)
    x = np.concatenate([rng.randn(4096), rng.randn(512) * 1e-30, rng.randn(512) * 1e30])
    x = x.astype(np.float32)
    ulp = np.float32(2.0) ** (np.floor(np.log2(np.abs(x))) - 10)
    ties = (np.floor(np.abs(x) / ulp) + 0.5) * ulp * np.sign(x)      # exact halfway points
    x = np.concatenate([x, ties.astype(np.float32), [0.0, -0.0, 1.0, -1.0]]).astype(np.float32)
    a = np.abs(x.astype(np.float64))
    unit = np.where(a > 0, 2.0 ** (np.floor(np.log2(np.where(a > 0, a, 1.0))) - 10), 1.0)
    want = np.sign(x) * np.floor(a / unit + 0.5) * unit
    got = rna(torch.from_numpy(x)).numpy()
    np.testing.assert_array_equal(got.astype(np.float64), want)
    # the split holds x to f32's own rounding: hi + lo == x exactly here
    hi, lo = split(torch.from_numpy(x))
    assert (hi.double() + lo.double() - torch.from_numpy(x).double()).abs().max() <= \
        2.0 ** -22 * torch.from_numpy(x).double().abs().max()


@pytest.mark.parametrize("B,Sq,Skv,H,KVH,hd,causal,window,q_offset", FUNCTION_CASES)
def test_split_tf32_bwd_matches_pallas_interpret(B, Sq, Skv, H, KVH, hd, causal, window,
                                                 q_offset):
    q, k, v, do = _inputs(B, Sq, Skv, H, KVH, hd, seed=Sq + H + window)
    kw = dict(causal=causal, window=window, q_offset=q_offset)
    o, lse = attention_fwd_ref(q, k, v, **kw)
    block = lambda n: next(b for b in (64, 50, 32) if n % b == 0)
    head_major = lambda t: jnp.asarray(t.transpose(1, 2).numpy())
    dq, dk, dv = jax_bwd(
        head_major(q), head_major(k), head_major(v), head_major(o), jnp.asarray(lse.numpy()),
        head_major(do), **kw, block_q=block(Sq), block_k=block(Skv), interpret=True)
    want = [np.moveaxis(np.asarray(g), 1, 2) for g in (dq, dk, dv)]
    got = bwd(q, k, v, o, lse, do, mm_split, **kw)
    for g, w in zip(got, want):
        np.testing.assert_allclose(g.numpy(), w, **TOL)
    # and the package's plain version, which the kernels are held against on the card
    for g, w in zip(got, attention_bwd_ref(q, k, v, o, lse, do, **kw)):
        np.testing.assert_allclose(g.numpy(), w.numpy(), **TOL)


@pytest.mark.parametrize("B,S,H,KVH,hd", F64_CASES)
def test_split_tf32_bwd_matches_f64(B, S, H, KVH, hd):
    args, ref = _f64_case(B, S, H, KVH, hd)
    assert _worst(bwd(*args, mm_split), ref) <= 1.0
    assert _worst(bwd(*args, mm_f32), ref) <= 1.0


def test_one_tf32_product_misses_the_tolerance():
    """Without the split (each operand rounded to TF32 once) the backward
    leaves FLASH_BWD_F32_TOL: the split is needed."""
    args, ref = _f64_case(*F64_CASES[0])
    assert _worst(bwd(*args, mm_tf32), ref) > 1.0


if __name__ == "__main__":
    # the port's f32 training shapes: qwen3-4b's attention at S 1000,
    # gemma-7b's (hd 256), whisper-tiny's (B4 S448 H6/6 hd64)
    for B, S, H, KVH, hd in ((1, 1000, 32, 8, 128), (1, 1000, 16, 16, 256), (4, 448, 6, 6, 64)):
        args, ref = _f64_case(B, S, H, KVH, hd)
        fr = {name: _worst(bwd(*args, mm), ref)
              for name, mm in (("plain f32", mm_f32), ("split TF32", mm_split),
                               ("one TF32", mm_tf32))}
        print(f"B{B} S{S} H{H}/{KVH} hd{hd}: worst error / limit "
              + ", ".join(f"{k} {v:.4f}" for k, v in fr.items()))
