"""The arithmetic of the f32 flash forward's CUDA kernel
(``flash_fwd_tf32_kernel``, csrc/flash_attention.cu), emulated on the CPU:
the online softmax over kv tiles of the kernel's size, with both products
(s = q k^T and the tile's share of p v) as split TF32 (3xTF32, the helpers
of ``tests/test_torch_flash_bwd_tf32.py``), each tile's share of o taken
from zero and joined to o by an f32 add.

The emulation lives here only; the package's plain version stays
``attention_fwd_ref``. It is held against the JAX package's Pallas forward
in interpret mode on the f32 FLASH cases (head dims 32 to 256, a window, a
q offset, ragged and non-causal lengths) and against an f64 reference at
S 512, hd 128 and hd 256, at the f32 kernel tolerance F32_TOL (atol = rtol
= 2e-5, chip_smoke.py's); one TF32 product per product, without the split,
misses it.

    PYTHONPATH=src python tests/test_torch_flash_fwd_tf32.py

prints, at the four shapes the f32 forward is timed at on the card, the
worst error of plain f32, the split and one TF32 product against the f64
reference, as a fraction of F32_TOL's limit.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels.flash_attention import flash_attention as jax_flash
from repro_torch.kernels.flash_attention import attention_fwd_ref
from repro_torch.kernels.flash_attention.ref import _mask
from test_torch_flash_bwd_tf32 import mm_f32, mm_split, mm_tf32, rna, split

TOL = dict(atol=2e-5, rtol=2e-5)      # chip_smoke.py's F32_TOL
NEG_INF = -1e30                       # csrc/common.cuh's masking value


def kv_tile(hd: int) -> int:
    """kv rows of a streamed tile (csrc/flash_attention.cu's tf32::Layout::BK)."""
    return 16 if hd > 128 else 64


# (B, Sq, Skv, H, KVH, hd, causal, window, q_offset): the f32 rows of
# tests/test_torch_kernels.py FLASH_CASES and FLASH_EXTRA_CASES, then
# chip_smoke.py's GEMMA_FLASH_CASES rows at hd 256 with a window, a q offset
# and a non-causal ragged length
FLASH_CASES = [
    (2, 256, 256, 4, 4, 64, True, 0, 0),
    (1, 256, 256, 8, 2, 64, True, 0, 0),
    (2, 128, 128, 4, 1, 32, True, 64, 0),
    (1, 384, 384, 4, 4, 128, True, 0, 0),
    (1, 200, 200, 4, 2, 32, True, 48, 0),
    (2, 333, 333, 8, 2, 128, True, 0, 0),
    (1, 64, 192, 4, 2, 64, True, 0, 128),
    (2, 100, 100, 4, 2, 64, False, 0, 0),
    (1, 200, 200, 4, 2, 256, True, 48, 0),
    (1, 64, 240, 4, 2, 256, True, 0, 176),
    (2, 100, 100, 4, 2, 256, False, 0, 0),
]
# (B, S, H, KVH, hd): against the f64 reference
F64_CASES = [
    (1, 512, 4, 2, 128),
    (1, 512, 2, 2, 256),
]


def fwd(q, k, v, mm, *, causal=True, window=0, q_offset=0, dtype=torch.float32):
    """(o (B, Sq, H, hd), lse (B, H, Sq, 1)) by the kernel's online softmax in
    ``dtype``, every product taken by ``mm``: over kv tiles of
    ``kv_tile(hd)`` rows (those with no live (q, k) pair skipped), s scaled
    and masked to NEG_INF, the running max m, corr = exp(m - m_new),
    p = exp(s - m_new), l = l corr + sum(p), o = o corr + (p v from zero);
    o times 1 / max(l, 1e-37), lse = m + log(max(l, 1e-37))."""
    B, Sq, H, hd = q.shape
    Skv, KVH = k.shape[1], k.shape[2]
    G, bk = H // KVH, kv_tile(hd)
    scale = float(1.0 / np.sqrt(hd))
    heads = lambda t, g: t.to(dtype).transpose(1, 2).repeat_interleave(g, dim=1)
    qh, kh, vh = heads(q, 1), heads(k, G), heads(v, G)                # (B, heads, S, hd)
    mask = _mask(Sq, Skv, causal, window, q_offset, q.device)
    m = torch.full((B, H, Sq, 1), NEG_INF, dtype=dtype)
    l = torch.zeros((B, H, Sq, 1), dtype=dtype)
    o = torch.zeros((B, H, Sq, hd), dtype=dtype)
    for k0 in range(0, Skv, bk):
        live = mask[:, k0:k0 + bk]
        if not live.any():
            continue
        s = mm(qh, kh[:, :, k0:k0 + bk].transpose(-1, -2)) * scale
        s = torch.where(live, s, torch.tensor(NEG_INF, dtype=dtype))
        m_new = torch.maximum(m, s.amax(-1, keepdim=True))
        corr = torch.exp(m - m_new)
        p = torch.exp(s - m_new)
        l = l * corr + p.sum(-1, keepdim=True)
        o = o * corr + mm(p, vh[:, :, k0:k0 + bk])
        m = m_new
    li = l.clamp_min(1e-37)
    return (o * (1.0 / li)).transpose(1, 2), m + torch.log(li)


def _inputs(B, Sq, Skv, H, KVH, hd, seed):
    rng = np.random.RandomState(seed)
    shapes = [(B, Sq, H, hd), (B, Skv, KVH, hd), (B, Skv, KVH, hd)]
    return [torch.from_numpy(rng.randn(*s).astype(np.float32)) for s in shapes]


def _worst(got, want) -> float:
    """The largest |got - want| / (atol + rtol |want|) over o and lse: at
    most 1 where TOL holds."""
    limit = lambda w: TOL["atol"] + TOL["rtol"] * w.double().abs()
    return max(float(((g.double() - w.double()).abs() / limit(w)).max())
               for g, w in zip(got, want))


def _f64_case(B, S, H, KVH, hd, seed=7, window=0):
    q, k, v = _inputs(B, S, S, H, KVH, hd, seed)
    return (q, k, v), fwd(q, k, v, mm_f32, window=window, dtype=torch.float64)


def test_split_helpers_round_as_the_kernel():
    """rna and split as imported: hi is a TF32 value (low 13 bits clear) and
    hi + lo holds x to 2^-22 of |x|."""
    x = torch.from_numpy(np.random.RandomState(1).randn(4096).astype(np.float32))
    hi, lo = split(x)
    assert torch.equal(rna(hi), hi) and torch.equal(rna(lo), lo)
    assert (hi.view(torch.int32) & 0x1FFF).eq(0).all()
    assert float((hi.double() + lo.double() - x.double()).abs().max()) <= \
        2.0 ** -22 * float(x.abs().max())


@pytest.mark.parametrize("B,Sq,Skv,H,KVH,hd,causal,window,q_offset", FLASH_CASES)
def test_split_tf32_fwd_matches_pallas_interpret(B, Sq, Skv, H, KVH, hd, causal, window,
                                                 q_offset):
    q, k, v = _inputs(B, Sq, Skv, H, KVH, hd, seed=Sq + H + hd + window)
    kw = dict(causal=causal, window=window, q_offset=q_offset)
    o, lse = fwd(q, k, v, mm_split, **kw)
    # the JAX wrapper pads a ragged causal length; a non-causal one takes
    # blocks that divide it
    blk = 128 if causal else next(b for b in (128, 64, 50, 32) if Skv % b == 0 and Sq % b == 0)
    want = jax_flash(*(jnp.asarray(t.numpy()) for t in (q, k, v)), causal, window, q_offset,
                     blk, blk, True)
    np.testing.assert_allclose(o.numpy(), np.asarray(want), **TOL)
    # and the package's plain version, which the kernel is held against on the card
    ro, rlse = attention_fwd_ref(q, k, v, **kw)
    np.testing.assert_allclose(o.numpy(), ro.numpy(), **TOL)
    np.testing.assert_allclose(lse.numpy(), rlse.numpy(), **TOL)


@pytest.mark.parametrize("B,S,H,KVH,hd", F64_CASES)
def test_split_tf32_fwd_matches_f64(B, S, H, KVH, hd):
    args, ref = _f64_case(B, S, H, KVH, hd)
    assert _worst(fwd(*args, mm_split), ref) <= 1.0
    assert _worst(fwd(*args, mm_f32), ref) <= 1.0


def test_one_tf32_product_misses_the_tolerance():
    """Without the split (each operand rounded to TF32 once) the forward
    leaves F32_TOL: the split is needed."""
    args, ref = _f64_case(*F64_CASES[0])
    assert _worst(fwd(*args, mm_tf32), ref) > 1.0


if __name__ == "__main__":
    # the f32 forward's timed shapes on the card (chip_smoke.py F32_FWD_SHAPES)
    for B, S, H, KVH, hd, window in ((1, 1000, 32, 8, 128, 0), (1, 1000, 16, 16, 256, 0),
                                     (4, 448, 6, 6, 64, 0), (1, 1500, 25, 5, 64, 1024)):
        args, ref = _f64_case(B, S, H, KVH, hd, window=window)
        fr = {name: _worst(fwd(*args, mm, window=window), ref)
              for name, mm in (("plain f32", mm_f32), ("split TF32", mm_split),
                               ("one TF32", mm_tf32))}
        print(f"B{B} S{S} H{H}/{KVH} hd{hd} w{window}: worst error / limit "
              + ", ".join(f"{k} {v:.4f}" for k, v in fr.items()))
