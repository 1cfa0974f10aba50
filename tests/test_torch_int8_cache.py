"""The port's int8 KV cache against the JAX package's, on the CPU: the
quantizer, the dense ring cache's and the paged pool's int8 decode, the
prefill's quantized cache, the engine's int8 pool, the byte counts and the
serve launcher's ``--int8-cache`` in every mode.

Tolerances. Codes ``==`` and scales rtol 1e-6, except that a code may be
off by one where ``x / scale`` lies within ``HALF_TIE`` (1e-5) of a
half-integer (XLA and torch may round the f32 quotient's last ulp apart
there); such codes are counted and must be rare. One decode attention
call at f32 atol 1e-5, at bf16 the repository's 2e-2. Reduced models at
f32: logits atol=rtol=1e-4 at every step and identical greedy streams.
int8 against bf16 serving: the reference's own rule
(``tests/test_serving_extras.py``), top-1 equal or correlation > 0.98.
The attention biases are overwritten with a seeded N(0, 0.5) draw in both
packages (the reference initializes them to zeros).
"""
import dataclasses
from collections import deque
import functools
import json
import os
from pathlib import Path
import subprocess
import sys
import textwrap

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.config import get_arch as jax_get_arch
from repro.dist import meshplan as jax_meshplan
from repro.models import build_model as jax_build_model
from repro.models import layers as jax_layers
from repro.models.transformer import RunOpts as JaxRunOpts
from repro_torch.config import ShardingLayout, get_arch
from repro_torch.dist import meshplan
from repro_torch.launch import serve
from repro_torch.models import RunOpts, build_model, common, layers
from repro_torch.models.convert import (
    cache_from_jax,
    cache_to_numpy,
    paged_cache_from_jax,
    params_from_jax,
)
from repro_torch.serve import DecodeEngine, Request

REPO = Path(__file__).resolve().parents[1]
Q4, Q32, VLM, QWEN3 = "qwen1.5-4b", "qwen1.5-32b", "internvl2-26b", "qwen3-4b"
F32, BF16 = "float32", "bfloat16"
TOL = dict(atol=1e-4, rtol=1e-4)
HALF_TIE = 1e-5
PS = 16


def _np(x):
    return x.float().numpy() if isinstance(x, torch.Tensor) else np.asarray(x, np.float32)


def _cfgs(arch, dtype=F32):
    return (dataclasses.replace(jax_get_arch(arch).reduced(), dtype=dtype),
            dataclasses.replace(get_arch(arch).reduced(), dtype=dtype))


@functools.lru_cache(maxsize=None)
def _jax_tree(arch):
    """The reference's reduced params (numpy), attention biases N(0, 0.5)."""
    tree = jax.tree_util.tree_map(np.asarray, jax_build_model(jax_get_arch(arch).reduced())
                                  .init(jax.random.key(0)))
    attn = tree["blocks"]["attn"]
    if "bq" in attn:
        rng = np.random.RandomState(1)
        for key in ("bq", "bk", "bv"):
            attn[key] = (0.5 * rng.randn(*attn[key].shape)).astype(np.float32)
    return tree


def _models(arch, dtype=F32):
    jcfg, cfg = _cfgs(arch, dtype)
    tree = _jax_tree(arch)
    tdtype = torch.bfloat16 if dtype == BF16 else None
    return (jax_build_model(jcfg), jax.tree_util.tree_map(jnp.asarray, tree),
            build_model(cfg), params_from_jax(tree, cfg, "cpu", dtype=tdtype))


def _hold_codes(got, want, x, scale):
    """Codes equal but where ``x / scale`` is within HALF_TIE of a
    half-integer, and there off by at most one. Returns how many differ."""
    got, want = np.asarray(got, np.int32), np.asarray(want, np.int32)
    ratio = np.asarray(x, np.float32) / np.asarray(scale, np.float32)
    tie = np.abs(np.abs(ratio - np.floor(ratio)) - 0.5) < HALF_TIE
    diff = got != want
    assert not (diff & ~tie).any(), f"{int((diff & ~tie).sum())} codes differ off a tie"
    assert (np.abs(got - want) <= 1).all()
    return int(diff.sum())


# ---------------------------------------------------------------------------
# the quantizer
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("dtype", [F32, BF16])
@pytest.mark.parametrize("shape", [(2, 16, 4, 32), (3, 5, 2, 128)])
def test_quantize_dequantize_match_jax(dtype, shape):
    x = np.random.RandomState(0).randn(*shape).astype(np.float32) * 3
    x[0, 0, 0] = 0.0                                   # an all-zero row: scale 1e-8
    jx = jnp.asarray(x, jnp.dtype(dtype))
    tx = torch.from_numpy(np.array(jx.astype(jnp.float32))).to(common.torch_dtype(dtype))
    jq, js = jax_layers._quantize_kv(jx)
    tq, ts = layers._quantize_kv(tx)
    assert tq.dtype == torch.int8 and tuple(ts.shape) == shape[:-1] + (1,)
    np.testing.assert_allclose(ts.numpy(), np.asarray(js), rtol=1e-6, atol=0)
    assert float(ts[0, 0, 0, 0]) == np.float32(1e-8)
    n = _hold_codes(tq.numpy(), jq, tx.float().numpy(), js)
    assert n <= 1e-4 * tq.numel()
    # dequantization with the scale stored in the cache dtype, as serving does
    for store in (F32, BF16):
        jsd = js.astype(jnp.dtype(store))
        tsd = ts.to(common.torch_dtype(store))
        want = jax_layers._dequantize_kv(jq, jsd, jnp.dtype(dtype))
        got = layers._dequantize_kv(torch.from_numpy(np.array(jq)), tsd,
                                    common.torch_dtype(dtype))
        assert got.dtype == common.torch_dtype(dtype)
        np.testing.assert_array_equal(_np(got), np.asarray(want, np.float32))


def test_quantize_rounds_half_to_even():
    """A row whose max is 127 has scale 1: x = 0.5, 1.5, 2.5, -2.5 give
    codes 0, 2, 2, -2, as ``jnp.round`` gives."""
    x = np.zeros((1, 1, 1, 8), np.float32)
    x[..., :5] = [127.0, 0.5, 1.5, 2.5, -2.5]
    tq, ts = layers._quantize_kv(torch.from_numpy(x))
    jq, _ = jax_layers._quantize_kv(jnp.asarray(x))
    assert float(ts.flatten()[0]) == 1.0
    assert tq.flatten()[:5].tolist() == [127, 0, 2, 2, -2] == np.asarray(jq).flatten()[:5].tolist()


# ---------------------------------------------------------------------------
# one decode attention call: the dense ring and the paged pool
# ---------------------------------------------------------------------------

def _layer(arch, dtype):
    jcfg, cfg = _cfgs(arch, dtype)
    one = {k: v[0] for k, v in _jax_tree(arch)["blocks"]["attn"].items()}
    return (jcfg, cfg, {k: jnp.asarray(v) for k, v in one.items()},
            {k: torch.from_numpy(np.array(v)) for k, v in one.items()})


def _quantized(shape, dtype, seed):
    """(codes, scales in ``dtype``) from the reference's quantizer."""
    x = jnp.asarray(np.random.RandomState(seed).randn(*shape).astype(np.float32),
                    jnp.dtype(dtype))
    q, s = jax_layers._quantize_kv(x)
    return np.asarray(q), np.asarray(s.astype(jnp.dtype(dtype)).astype(jnp.float32))


def _to_port(tree, dtype):
    return {k: torch.from_numpy(v.copy()).to(common.torch_dtype(dtype))
            if v.dtype == np.float32 else torch.from_numpy(v.copy()) for k, v in tree.items()}


def _hold_out(got, want, dtype):
    t = dict(atol=1e-5, rtol=0) if dtype == F32 else dict(atol=2e-2, rtol=2e-2)
    np.testing.assert_allclose(_np(got), np.asarray(want, np.float32), **t)


@pytest.mark.parametrize("dtype", [F32, BF16])
@pytest.mark.parametrize("arch", [Q32, QWEN3])
def test_dense_decode_attention_int8_matches_jax(arch, dtype):
    """A 32-slot ring holding positions 0..19 (the rest empty), the token
    at 20: output, the new codes and scales, and the untouched slots."""
    jcfg, cfg, jp, tp = _layer(arch, dtype)
    B, T, KVH, hd = 2, 32, cfg.num_kv_heads, cfg.resolved_head_dim
    kq, ks = _quantized((B, T, KVH, hd), dtype, 1)
    vq, vs = _quantized((B, T, KVH, hd), dtype, 2)
    pos_ids = np.where(np.arange(T) < 20, np.arange(T), -1).astype(np.int32)
    cache = {"k": kq, "v": vq, "k_scale": ks, "v_scale": vs, "pos_ids": pos_ids}
    x = np.random.RandomState(3).randn(B, 1, cfg.d_model).astype(np.float32)
    jcache = {k: jnp.asarray(v, jnp.dtype(dtype)) if v.dtype == np.float32 else jnp.asarray(v)
              for k, v in cache.items()}
    want, jnew = jax_layers.decode_attention(jp, jcache, jnp.asarray(x, jnp.dtype(dtype)),
                                             jnp.int32(20), jcfg)
    tcache = _to_port(cache, dtype)
    got, tnew = layers.decode_attention(tp, tcache, torch.from_numpy(x).to(
        common.torch_dtype(dtype)), 20, cfg)
    assert tnew is tcache and tnew["k"].dtype == torch.int8
    _hold_out(got, want, dtype)
    for key in ("k", "v"):
        others = np.arange(T) != 20
        assert np.array_equal(tnew[key].numpy()[:, others], np.asarray(jnew[key])[:, others])
        if dtype == F32:
            np.testing.assert_allclose(_np(tnew[key + "_scale"]),
                                       np.asarray(jnew[key + "_scale"]), rtol=1e-6)
            assert np.abs(tnew[key].numpy()[:, 20].astype(int)
                          - np.asarray(jnew[key])[:, 20]).max() <= 1
        else:
            deq = lambda c, s: _np(c).astype(np.float32) * _np(s)
            np.testing.assert_allclose(
                deq(tnew[key][:, 20], tnew[key + "_scale"][:, 20]),
                deq(jnew[key][:, 20], jnew[key + "_scale"][:, 20]), atol=2e-2, rtol=2e-2)
    assert tnew["pos_ids"][20] == 20


def _pool(cfg, dtype, P, seed=1):
    shape = (P, PS, cfg.num_kv_heads, cfg.resolved_head_dim)
    kq, ks = _quantized(shape, dtype, seed)
    vq, vs = _quantized(shape, dtype, seed + 1)
    return {"k_pages": kq, "v_pages": vq, "k_scale": ks, "v_scale": vs}


# three lanes: two live on scattered pages, one dead (no page at its write index)
TABLE = np.asarray([[5, 1, 3], [-1, -1, -1], [0, 6, -1]], np.int32)
LENS = np.asarray([40, 0, 21], np.int32)


@pytest.mark.parametrize("dtype", [F32, BF16])
@pytest.mark.parametrize("arch", [Q32, QWEN3])
def test_paged_decode_attention_int8_matches_jax(arch, dtype):
    jcfg, cfg, jp, tp = _layer(arch, dtype)
    pool = _pool(cfg, dtype, P=8)
    x = np.random.RandomState(4).randn(3, 1, cfg.d_model).astype(np.float32)
    jpool = {k: jnp.asarray(v, jnp.dtype(dtype)) if v.dtype == np.float32 else jnp.asarray(v)
             for k, v in pool.items()}
    want, jnew = jax_layers.decode_attention_paged(
        jp, jpool, jnp.asarray(x, jnp.dtype(dtype)), jnp.asarray(LENS), jnp.asarray(TABLE), jcfg)
    tpool = _to_port(pool, dtype)
    got = layers.decode_attention_paged(tp, tpool, torch.from_numpy(x).to(
        common.torch_dtype(dtype)), torch.from_numpy(LENS), torch.from_numpy(TABLE), cfg)
    _hold_out(got[[0, 2]], np.asarray(want, np.float32)[[0, 2]], dtype)
    assert tpool["k_pages"].dtype == torch.int8
    # the written rows: lane 0 at page 3 row 8 (position 40), lane 2 at
    # page 6 row 5 (position 21), the dead lane in the trash page; every
    # other row untouched
    written = np.zeros((8, PS), bool)
    written[3, 8] = written[6, 5] = True
    written[-1] = True
    for key in ("k_pages", "v_pages", "k_scale", "v_scale"):
        a, b = _np(tpool[key]), np.asarray(jnew[key], np.float32)
        assert np.array_equal(a[~written], b[~written])
        assert np.array_equal(a[~written], pool[key][~written].astype(np.float32))
        if dtype == F32 and key.endswith("pages"):
            assert np.abs(a[3, 8] - b[3, 8]).max() <= 1 and np.abs(a[6, 5] - b[6, 5]).max() <= 1
        elif dtype == F32:
            np.testing.assert_allclose(a[written], b[written], rtol=1e-6)


def test_paged_int8_scoped_dequant_equals_whole_pool_bitwise():
    """The port's copy of the reference's property: dequantizing only the
    gathered pages gives the bits that dequantizing the whole pool before
    the same gather and masked attention gives (bf16, reduced qwen3-4b,
    one layer)."""
    cfg = dataclasses.replace(get_arch(QWEN3).reduced(), num_layers=1)
    params = common.init_params(layers.attention_spec(cfg), torch.Generator().manual_seed(0),
                                "cpu")
    gen = torch.Generator().manual_seed(7)
    B, nb = 2, 3
    P, KVH, hd = B * nb + 1, cfg.num_kv_heads, cfg.resolved_head_dim
    draw = lambda *s: torch.randn(s, generator=gen).to(torch.bfloat16)
    kq, ks = layers._quantize_kv(draw(P, PS, KVH, hd))
    vq, vs = layers._quantize_kv(draw(P, PS, KVH, hd))
    cache = {"k_pages": kq, "v_pages": vq, "k_scale": ks.to(torch.bfloat16),
             "v_scale": vs.to(torch.bfloat16)}
    table = torch.tensor([[0, 1, 2], [3, 4, -1]], dtype=torch.int32)
    lens = torch.tensor([40, 21], dtype=torch.int32)
    x = draw(B, 1, cfg.d_model)
    y_scoped = layers.decode_attention_paged(params, cache, x, lens, table, cfg)

    q, _, _ = layers._project_qkv(params, x, x, cfg)
    q = layers.rope(q, lens[:, None].float(), cfg.rope_theta)
    full_k = layers._dequantize_kv(cache["k_pages"], cache["k_scale"], x.dtype)
    full_v = layers._dequantize_kv(cache["v_pages"], cache["v_scale"], x.dtype)
    tbl = torch.clamp(table, min=0).long()
    kg = full_k[tbl].reshape(B, nb * PS, KVH, hd)
    vg = full_v[tbl].reshape(B, nb * PS, KVH, hd)
    mask = (torch.arange(nb * PS)[None, :] < (lens + 1)[:, None])[:, None, :]
    att = layers._sdpa(q[:, 0].reshape(B, 1, KVH, -1, hd), kg, vg, mask, float(hd ** -0.5))
    y_full = common.dense(att.reshape(B, 1, cfg.num_heads * hd), params["wo"], cfg.dtype)
    assert y_scoped.dtype == torch.bfloat16
    assert torch.equal(y_scoped, y_full), float((y_scoped.float() - y_full.float()).abs().max())


# ---------------------------------------------------------------------------
# reduced models: prefill + decode, int8 against the reference's int8
# ---------------------------------------------------------------------------

S, NEW = 20, 4


def _batch(cfg, B, seed=0):
    batch = {"tokens": np.random.RandomState(seed).randint(0, cfg.vocab_size, (B, S))
             .astype(np.int32)}
    if cfg.vision_tokens:
        batch["patches"] = np.random.RandomState(seed + 1).randn(
            B, cfg.vision_tokens, cfg.vision_width).astype(np.float32)
    return batch


@pytest.mark.parametrize("arch", [Q32, VLM, Q4])
def test_prefill_decode_int8_matches_jax(arch):
    """Prefill (int8 cache) then 3 decode steps at f32: logits at every
    step, streams, and the prefill's codes and scales."""
    jm, jp, m, p = _models(arch)
    batch = _batch(m.cfg, 2)
    jo, to = JaxRunOpts(int8_kv_cache=True), RunOpts(int8_kv_cache=True)
    jl, jc = jm.prefill(jp, {k: jnp.asarray(v) for k, v in batch.items()}, S + NEW, jo)
    tl, tc = m.prefill(p, {k: torch.from_numpy(v) for k, v in batch.items()}, S + NEW, to)
    assert set(tc["blocks"]) == set(jc["blocks"]) == {"k", "v", "k_scale", "v_scale", "pos_ids"}
    for key in ("k", "v"):
        assert tc["blocks"][key].dtype == torch.int8
        np.testing.assert_allclose(_np(tc["blocks"][key + "_scale"]),
                                   np.asarray(jc["blocks"][key + "_scale"]), rtol=1e-5)
        diff = np.abs(tc["blocks"][key].numpy().astype(int) - np.asarray(jc["blocks"][key]))
        assert diff.max() <= 1 and (diff > 0).mean() < 1e-3
    for i in range(NEW):
        np.testing.assert_allclose(_np(tl[:, -1]), np.asarray(jl[:, -1]), **TOL, err_msg=str(i))
        jt = jnp.argmax(jl[:, -1], axis=-1).astype(jnp.int32)[:, None]
        tt = tl[:, -1].argmax(-1).to(torch.int32)[:, None]
        assert np.array_equal(tt.numpy(), np.asarray(jt)), f"step {i}"
        if i + 1 < NEW:
            jl, jc = jm.decode_step(jp, jc, jt, jnp.int32(S + i), jo)
            tl, tc = m.decode_step(p, tc, tt, S + i, to)
    assert tc["blocks"]["k"].dtype == torch.int8


def _greedy(m, p, batch, opts, new=NEW):
    logits, cache = m.prefill(p, batch, S + new, opts)
    outs = []
    for i in range(new):
        outs.append(_np(logits[:, -1]))
        if i + 1 < new:
            logits, cache = m.decode_step(p, cache, batch["next"][:, i:i + 1], S + i, opts)
    return outs


@pytest.mark.parametrize("arch", [QWEN3, Q32])
def test_int8_cache_matches_bf16_topk(arch):
    """The reference's rule on the port: bf16 serving with the int8 cache
    against the bf16 cache, teacher-forced on the same tokens."""
    _, _, m, p = _models(arch, BF16)
    rng = np.random.RandomState(5)
    toks = torch.from_numpy(rng.randint(0, m.cfg.vocab_size, (2, S + NEW)).astype(np.int32))
    batch = {"tokens": toks[:, :S], "next": toks[:, S:]}
    ref = _greedy(m, p, batch, RunOpts())
    q = _greedy(m, p, batch, RunOpts(int8_kv_cache=True))
    for a, b in zip(ref, q):
        for r in range(2):
            assert (np.argmax(a[r]) == np.argmax(b[r])
                    or np.corrcoef(a[r], b[r])[0, 1] > 0.98)


def test_int8_cache_round_trips_from_jax():
    """A JAX int8 prefill cache (dense) and an int8 pool come across
    exactly, and back."""
    jm, jp, m, _ = _models(Q32)
    batch = _batch(m.cfg, 2)
    _, jc = jm.prefill(jp, {k: jnp.asarray(v) for k, v in batch.items()}, S + NEW,
                       JaxRunOpts(int8_kv_cache=True))
    jc = jax.tree_util.tree_map(np.asarray, jc)
    tc = cache_from_jax(jc, m.cfg, 2, S + NEW, "cpu")
    assert tc["blocks"]["k"].dtype == torch.int8
    back = cache_to_numpy(tc)
    for key, want in jc["blocks"].items():
        assert back["blocks"][key].dtype == (np.float32 if "scale" in key else want.dtype)
        assert np.array_equal(back["blocks"][key], want), key
    jpool = jax.tree_util.tree_map(np.asarray, jm.init_paged_cache(5, int8=True))
    tpool = paged_cache_from_jax(jpool, m.cfg, "cpu")
    assert tpool["blocks"]["k_pages"].dtype == torch.int8
    assert tuple(tpool["blocks"]["k_scale"].shape) == jpool["blocks"]["k_scale"].shape
    specs = m.paged_cache_specs(5, int8=True)
    assert common.tree_map(lambda s: s.shape, specs) == \
        common.tree_map(lambda t: tuple(t.shape), tpool)


# ---------------------------------------------------------------------------
# the engine's int8 pool against the reference's prefill + decode_step_paged
# ---------------------------------------------------------------------------

PROMPT_LENS = (5, 17, 9, 30)
ENGINE_NEW = 6


def _jax_int8_oracle(jm, jp, reqs, lanes, num_pages, max_context):
    """Greedy streams from the reference's ``prefill`` (int8 cache) and
    ``decode_step_paged`` (default ``RunOpts()``: the int8 pool takes its
    gather path) under the engine's FIFO schedule; codes and scales packed
    into the same pages as the engine packs them."""
    max_blocks = -(-max_context // PS)
    free = deque(range(num_pages - 1))
    pending = deque(reqs)
    slots = [None] * lanes          # [rid, pages, seq_len, current, generated]
    done = {}
    cache = jm.init_paged_cache(num_pages, int8=True)
    keys = {"k": "k_pages", "v": "v_pages", "k_scale": "k_scale", "v_scale": "v_scale"}
    while pending or any(slots):
        while pending and None in slots:
            r = pending[0]
            need = -(-(len(r.prompt) + r.max_new_tokens) // PS)
            if need > len(free):
                break
            pending.popleft()
            pages = [free.popleft() for _ in range(need)]
            n = len(r.prompt)
            logits, dense = jm.prefill(jp, {"tokens": jnp.asarray(r.prompt[None])}, n,
                                       JaxRunOpts(int8_kv_cache=True))
            n_dense = dense["blocks"]["k"].shape[2] // PS
            for dk, pk in keys.items():
                src = dense["blocks"][dk][:, 0]
                L, T = src.shape[:2]
                cache["blocks"][pk] = cache["blocks"][pk].at[:, jnp.asarray(pages[:n_dense])].set(
                    src.reshape(L, T // PS, PS, *src.shape[2:]).astype(cache["blocks"][pk].dtype))
            cur = int(jnp.argmax(logits[0, -1]))
            slots[slots.index(None)] = [r.rid, pages, n, cur, [cur]]
        active = [i for i, s in enumerate(slots) if s is not None]
        tokens = np.zeros((lanes, 1), np.int32)
        seq_lens = np.zeros(lanes, np.int32)
        table = np.full((lanes, max_blocks), -1, np.int32)
        for i in active:
            _, pages, sl, cur, _ = slots[i]
            tokens[i, 0], seq_lens[i] = cur, sl
            table[i, :len(pages)] = pages
        logits, cache = jm.decode_step_paged(jp, cache, jnp.asarray(tokens),
                                             jnp.asarray(seq_lens), jnp.asarray(table))
        nxt = np.asarray(jnp.argmax(logits[:, -1], axis=-1))
        for i in active:
            s = slots[i]
            s[2] += 1
            s[3] = int(nxt[i])
            s[4].append(s[3])
            if len(s[4]) >= ENGINE_NEW:
                free.extend(s[1])
                done[s[0]] = s[4]
                slots[i] = None
    return done


@pytest.mark.parametrize("arch", [Q32, QWEN3])
def test_int8_engine_streams_equal_jax_oracle(arch):
    """Reduced f32, 2 lanes, a 7-page pool (page pressure: requests wait)."""
    jm, jp, m, p = _models(arch)
    rng = np.random.RandomState(0)
    reqs = [Request(rid=i, prompt=rng.randint(0, m.cfg.vocab_size, n).astype(np.int32),
                    max_new_tokens=ENGINE_NEW) for i, n in enumerate(PROMPT_LENS)]
    eng = DecodeEngine(m, ShardingLayout(int8_kv_cache=True), "cpu", lanes=2, num_pages=7,
                       max_context=48)
    assert eng.cache["blocks"]["k_pages"].dtype == torch.int8
    for r in reqs:
        eng.submit(r)
    got = {c.rid: c.tokens for c in eng.run(p)}
    want = _jax_int8_oracle(jm, jp, reqs, lanes=2, num_pages=7, max_context=48)
    assert got == want
    assert eng.free_pages == 6


def test_engine_pool_bytes_count_int8():
    """The engine's pool bytes: codes at 1 byte, scales in the compute
    dtype; against the same pool in that dtype."""
    cfg = get_arch(Q32).reduced()
    m = build_model(cfg)
    L, KVH, hd = cfg.num_layers, cfg.num_kv_heads, cfg.resolved_head_dim
    rows = L * 9 * PS * KVH
    eng8 = DecodeEngine(m, ShardingLayout(int8_kv_cache=True), "cpu", lanes=2, num_pages=9,
                        max_context=48)
    eng16 = DecodeEngine(m, ShardingLayout(), "cpu", lanes=2, num_pages=9, max_context=48)
    assert eng8.pool_bytes == 2 * rows * (hd + 2)
    assert eng16.pool_bytes == 2 * rows * hd * 2


def test_engine_refuses_a_vision_prefix():
    with pytest.raises(NotImplementedError, match="vision"):
        DecodeEngine(build_model(get_arch(VLM).reduced()), ShardingLayout(int8_kv_cache=True),
                     "cpu", lanes=1, num_pages=4, max_context=48)


# ---------------------------------------------------------------------------
# byte counts and the launcher
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("arch", [Q32, Q4, VLM, QWEN3])
@pytest.mark.parametrize("int8", [False, True])
def test_serve_state_bytes_equal_reference(arch, int8):
    for pick in (lambda c: c, lambda c: c.reduced()):
        ours = meshplan.serve_state_bytes(build_model(pick(get_arch(arch))), 8, 2048,
                                          int8_cache=int8)
        ref = jax_meshplan.serve_state_bytes(jax_build_model(pick(jax_get_arch(arch))), 8, 2048,
                                             int8_cache=int8)
        assert ours == ref


def test_qwen1_5_32b_pool_arithmetic():
    """One cached token over all 64 layers, and a 769-page pool (768 live
    + the trash page) in int8 and in bf16, from the specs."""
    m = build_model(get_arch(Q32))
    per_token = lambda int8: common.param_bytes(m.paged_cache_specs(1, 1, int8=int8))
    assert per_token(True) == 655_360 + 10_240 == 665_600
    assert per_token(False) == 1_310_720
    assert common.param_bytes(m.paged_cache_specs(769, int8=True)) == 769 * 16 * 665_600
    assert common.param_bytes(m.paged_cache_specs(769)) == 769 * 16 * 1_310_720
    weights = common.param_bytes(m.specs) // 2          # bf16 storage of f32 specs
    assert weights == 2 * m.param_count() == 70_394_193_920


B, PLAN_S, PLAN_NEW, REVOKE = 4, 16, 8, 3
BASE = ["--arch", Q32, "--batch", str(B), "--prompt-len", str(PLAN_S),
        "--new-tokens", str(PLAN_NEW), "--device", "cpu", "--int8-cache"]
BYTE_COLUMNS = ("plans", "params_bytes", "cache_bytes", "train_path_bytes", "migrated_at",
                "cache_policy")

REFERENCE_SCRIPT = textwrap.dedent(
    """
    import os
    os.environ["XLA_FLAGS"] = "--xla_force_host_platform_device_count=8"
    import contextlib, io, json, sys
    from repro.launch import serve

    def plan_json(argv):
        out = io.StringIO()
        sys.argv = ["serve"] + argv
        with contextlib.redirect_stdout(out):
            serve.main()
        for line in out.getvalue().splitlines():
            if line.startswith("PLAN_JSON "):
                return json.loads(line[len("PLAN_JSON "):])
        raise AssertionError(out.getvalue())

    base = ["--arch", "%s", "--batch", "%d", "--prompt-len", "%d", "--new-tokens", "%d",
            "--int8-cache"]
    print("REF_JSON " + json.dumps({p: plan_json(base + ["--plan", "8,4", "--revoke-after",
                                                         "%d", "--cache-policy", p])
                                    for p in ("drop", "migrate")}))
    """ % (Q32, B, PLAN_S, PLAN_NEW, REVOKE)
)


@pytest.fixture(scope="module")
def reference():
    res = subprocess.run([sys.executable, "-c", REFERENCE_SCRIPT], capture_output=True,
                         text=True, timeout=600, cwd=str(REPO),
                         env={**os.environ, "PYTHONPATH": str(REPO / "src")})
    for line in res.stdout.splitlines():
        if line.startswith("REF_JSON "):
            return json.loads(line[len("REF_JSON "):])
    raise AssertionError(res.stdout + res.stderr)


@pytest.mark.parametrize("form", [["--cache-policy", "drop"], ["--cache-policy", "migrate"],
                                  ["--engine"]], ids=["drop", "migrate", "engine"])
def test_cli_plan_int8_byte_columns_equal_reference(reference, form, capsys):
    """``--plan 8,4 --int8-cache``: the byte columns of the reference's
    dense ``plan_main`` (its engine cannot run under this JAX version; the
    engine's ``params_bytes`` is the dense path's), and the migrated cache
    is the int8 one: fewer bytes than a bf16 cache's migration."""
    out = serve.main(BASE + ["--plan", "8,4", "--revoke-after", str(REVOKE)] + form)
    lines = capsys.readouterr().out.splitlines()
    assert json.loads(next(l for l in lines if l.startswith("PLAN_JSON "))[10:]) == \
        json.loads(json.dumps(out))
    ref = reference["migrate" if "migrate" in form else "drop"]
    assert {k: out[k] for k in BYTE_COLUMNS} == {k: ref[k] for k in BYTE_COLUMNS}
    if "migrate" in form:
        bf16 = serve.main(BASE[:-1] + ["--plan", "8,4", "--revoke-after", str(REVOKE)] + form)
        assert 0 < out["cache_bytes"] < bf16["cache_bytes"]


def test_int8_plan_streams_survive_migration():
    """Reduced f32 qwen1.5-32b with an int8 dense cache: the migrate and
    drop round trips give the uninterrupted stream (the scales move with
    the codes; drop re-prefills into a fresh int8 cache)."""
    _, _, m, p = _models(Q32)
    prompts = np.random.RandomState(0).randint(0, m.cfg.vocab_size, (B, PLAN_S)).astype(np.int32)
    run = lambda counts, **kw: serve.serve_plan(m, p, prompts, PLAN_NEW, counts, device="cpu",
                                                int8_cache=True, **kw)["tokens"]
    whole = run([8])
    assert run([8, 4], revoke_after=REVOKE, cache_policy="migrate") == whole
    assert run([8, 4], revoke_after=REVOKE, cache_policy="drop") == whole
    assert run([8, 4], revoke_after=REVOKE, engine=True) == whole


@pytest.mark.parametrize("arch,flags", [(Q32, ["--int8-cache"]), (VLM, []),
                                        (VLM, ["--int8-cache"]), (Q4, [])])
def test_host_main_serves_the_dense_variants(arch, flags, capsys):
    out = serve.main(["--arch", arch, "--batch", "2", "--prompt-len", "12", "--new-tokens",
                      "4", "--device", "cpu"] + flags)
    assert out["int8_cache"] == ("--int8-cache" in flags)
    assert len(out["first_row"]) == 4 and all(0 <= t < 256 for t in out["first_row"])
    assert '"serve done"' in capsys.readouterr().out
