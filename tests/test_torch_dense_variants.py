"""The port's dense variants against the JAX package's, on the CPU: the
QKV bias (qwen1.5-4b, qwen1.5-32b), the VLM's vision prefix
(internvl2-26b) and the ``triangular`` causal chunk schedule.

Reduced configs at f32, weights from the reference's ``init``
(``jax.random.key(0)``) carried across by ``params_from_jax``. The
reference initializes ``bq``, ``bk`` and ``bv`` to zeros, so a port that
never added them would pass every comparison built on ``init``: every test
here overwrites them in both packages with a seeded N(0, 0.5) draw first
(``_biased``), and ``test_dropping_the_bias_add_fails`` shows that the
comparison then catches a missing add. Inputs are made with numpy from a
seed. Tolerances (XLA and torch sum in different orders): ``_project_qkv``
and one attention layer atol 1e-5; logits atol=rtol=1e-4 with identical
greedy streams; training loss and grad norm rtol 1e-4, params (the bias
leaves included) atol 1e-5; blockwise attention atol 1e-5, and the
triangular schedule equal to the port's own masked one bit for bit (the kv
chunks it skips are wholly masked, which adds exact zeros).
"""
import dataclasses
import functools
from pathlib import Path
from unittest import mock

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.config import ShardingLayout as JaxLayout
from repro.config import TrainConfig as JaxTrainConfig
from repro.config import get_arch as jax_get_arch
from repro.data import SyntheticLM as JaxSyntheticLM
from repro.models import build_model as jax_build_model
from repro.models import layers as jax_layers
from repro.models import transformer as jax_transformer
from repro.models.transformer import RunOpts as JaxRunOpts
from repro.train import steps as jax_steps
from repro_torch.config import ShardingLayout, TrainConfig, get_arch
from repro_torch.data import SyntheticLM
from repro_torch.models import RunOpts, build_model, layers, transformer
from repro_torch.models.convert import (
    params_from_jax,
    train_state_from_jax,
    train_state_to_numpy,
)
from repro_torch.train import steps

REPO = Path(__file__).resolve().parents[1]
Q4, Q32, VLM = "qwen1.5-4b", "qwen1.5-32b", "internvl2-26b"
F32 = "float32"
NEW = 6
TOL = dict(atol=1e-4, rtol=1e-4)


def _np(x):
    return x.float().numpy() if isinstance(x, torch.Tensor) else np.asarray(x, np.float32)


def _spec_fields(tree):
    if isinstance(tree, dict):
        return {k: _spec_fields(v) for k, v in tree.items()}
    return (tuple(tree.shape), tuple(tree.axes), tree.init, tree.scale, tree.dtype)


def _cfgs(arch, dtype=F32):
    return (dataclasses.replace(jax_get_arch(arch).reduced(), dtype=dtype),
            dataclasses.replace(get_arch(arch).reduced(), dtype=dtype))


def _biased(tree, seed=1):
    """``tree`` (numpy, JAX layout) with every attention bias leaf replaced
    by a seeded N(0, 0.5) draw; other leaves are shared, not copied."""
    rng = np.random.RandomState(seed)
    out = dict(tree)
    if "blocks" in tree and "bq" in tree["blocks"]["attn"]:
        attn = dict(tree["blocks"]["attn"])
        for key in ("bq", "bk", "bv"):
            attn[key] = (0.5 * rng.randn(*attn[key].shape)).astype(np.float32)
        out["blocks"] = dict(tree["blocks"], attn=attn)
    return out


@functools.lru_cache(maxsize=None)
def _jax_params(arch):
    jcfg = jax_get_arch(arch).reduced()
    return _biased(jax.tree_util.tree_map(np.asarray, jax_build_model(jcfg).init(
        jax.random.key(0))))


def _models(arch):
    """(JAX model, JAX params, port model, port params), f32, biased."""
    jcfg, cfg = _cfgs(arch)
    tree = _jax_params(arch)
    return (jax_build_model(jcfg), jax.tree_util.tree_map(jnp.asarray, tree),
            build_model(cfg), params_from_jax(tree, cfg, "cpu"))


def _patches(cfg, B, seed=3):
    return np.random.RandomState(seed).randn(B, cfg.vision_tokens,
                                             cfg.vision_width).astype(np.float32)


# ---------------------------------------------------------------------------
# configs and specs
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("module", ["qwen1_5_4b.py", "qwen1_5_32b.py", "internvl2_26b.py",
                                    "gemma_7b.py", "whisper_tiny.py"])
def test_config_copy_equals_reference_apart_from_imports(module):
    port = (REPO / "src" / "repro_torch" / "configs" / module).read_text()
    ref = (REPO / "src" / "repro" / "configs" / module).read_text()
    assert port.replace("repro_torch", "repro") == ref


@pytest.mark.parametrize("arch", [Q4, Q32, VLM])
@pytest.mark.parametrize("reduced", [False, True])
def test_specs_match_jax(arch, reduced):
    pick = (lambda c: c.reduced()) if reduced else (lambda c: c)
    cfg, jcfg = pick(get_arch(arch)), pick(jax_get_arch(arch))
    assert dataclasses.asdict(cfg) == dataclasses.asdict(jcfg)
    assert _spec_fields(build_model(cfg).specs) == _spec_fields(jax_build_model(jcfg).specs)
    assert build_model(cfg).param_count() == jax_build_model(jcfg).param_count() \
        == jcfg.param_count()
    for int8 in (False, True):
        assert (_spec_fields(transformer.cache_specs(cfg, 2, 40, int8=int8))
                == _spec_fields(jax_transformer.cache_specs(jcfg, 2, 40, int8=int8)))
    assert transformer.cache_len_for(cfg, 2048) == jax_transformer.cache_len_for(jcfg, 2048)


def test_full_width_shapes():
    q4, q32, vlm = get_arch(Q4), get_arch(Q32), get_arch(VLM)
    assert (q4.num_layers, q4.d_model, q4.num_heads, q4.num_kv_heads, q4.qkv_bias) == \
        (40, 2560, 20, 20, True)
    assert (q32.num_layers, q32.d_model, q32.num_heads, q32.num_kv_heads, q32.rope_theta) == \
        (64, 5120, 40, 40, 1e6)
    assert (vlm.num_layers, vlm.num_heads, vlm.num_kv_heads, vlm.vision_tokens,
            vlm.vision_width) == (48, 48, 8, 1025, 3200)
    count = lambda a: build_model(get_arch(a)).param_count() / 1e9
    assert (round(count(Q4), 3), round(count(Q32), 3), round(count(VLM), 3)) == \
        (3.950, 35.197, 19.881)
    # internvl2's prefix makes a 2048-token prompt a 3073-row prefill
    assert transformer.cache_len_for(vlm, 2048 + 32) == 3120


def test_biases_and_projector_carry_across():
    """``params_from_jax`` takes the bias leaves (f32 at any storage dtype)
    and ``vision_proj`` (a matrix, stored in the serving dtype)."""
    tree = _jax_params(Q4)
    p = params_from_jax(tree, get_arch(Q4).reduced(), "cpu", dtype=torch.bfloat16)
    for key in ("bq", "bk", "bv"):
        assert p["blocks"]["attn"][key].dtype == torch.float32
        assert np.array_equal(p["blocks"]["attn"][key].numpy(), tree["blocks"]["attn"][key])
        assert float(p["blocks"]["attn"][key].abs().max()) > 0
    vt = _jax_params(VLM)
    pv = params_from_jax(vt, get_arch(VLM).reduced(), "cpu", dtype=torch.bfloat16)
    assert pv["vision_proj"].dtype == torch.bfloat16
    np.testing.assert_array_equal(pv["vision_proj"].float().numpy(),
                                  np.asarray(jnp.asarray(vt["vision_proj"], jnp.bfloat16),
                                             np.float32))


# ---------------------------------------------------------------------------
# QKV bias: the projection, one attention layer
# ---------------------------------------------------------------------------

def _layer_params(arch, seed=1):
    tree = _jax_params(arch)
    one = {k: v[0] for k, v in tree["blocks"]["attn"].items()}
    return ({k: jnp.asarray(v) for k, v in one.items()},
            {k: torch.from_numpy(np.array(v)) for k, v in one.items()})


@pytest.mark.parametrize("arch", [Q4, Q32])
def test_project_qkv_matches_jax(arch):
    jcfg, cfg = _cfgs(arch)
    jp, tp = _layer_params(arch)
    x = np.random.RandomState(0).randn(2, 7, cfg.d_model).astype(np.float32)
    want = jax_layers._project_qkv(jp, jnp.asarray(x), jnp.asarray(x), jcfg)
    got = layers._project_qkv(tp, torch.from_numpy(x), torch.from_numpy(x), cfg)
    for a, b in zip(got, want):
        np.testing.assert_allclose(_np(a), np.asarray(b), atol=1e-5, rtol=0)


@pytest.mark.parametrize("arch", [Q4, Q32])
@pytest.mark.parametrize("attn_impl", ["masked", "triangular", "flash"])
def test_attention_layer_matches_jax(arch, attn_impl):
    jcfg, cfg = _cfgs(arch)
    jp, tp = _layer_params(arch)
    S = 40
    x = np.random.RandomState(1).randn(2, S, cfg.d_model).astype(np.float32)
    pos = np.broadcast_to(np.arange(S, dtype=np.int32), (2, S))
    want = jax_layers.full_attention_layer(jp, jnp.asarray(x), jnp.asarray(pos), jcfg,
                                           q_chunk=16, kv_chunk=16, impl="masked")
    opts = RunOpts(attn_impl=attn_impl, q_chunk=16, kv_chunk=16)
    got, _ = transformer._attn_full(tp, torch.from_numpy(x), torch.from_numpy(pos.copy()),
                                    cfg, opts)
    np.testing.assert_allclose(_np(got), np.asarray(want), atol=1e-5, rtol=0)


# ---------------------------------------------------------------------------
# reduced models: prefill, decode_step, decode_step_paged
# ---------------------------------------------------------------------------

def _prompt(vocab, B, S, seed=0):
    return np.random.RandomState(seed).randint(0, vocab, (B, S)).astype(np.int32)


@functools.lru_cache(maxsize=None)
def _jax_greedy(arch, B, S):
    jm, jp, _, _ = _models(arch)
    batch = {"tokens": jnp.asarray(_prompt(jm.cfg.vocab_size, B, S))}
    if jm.cfg.vision_tokens:
        batch["patches"] = jnp.asarray(_patches(jm.cfg, B))
    logits, cache = jax.jit(lambda p, b: jm.prefill(p, b, S + NEW))(jp, batch)
    decode = jax.jit(jm.decode_step)
    toks, outs = [], []
    for i in range(NEW):
        outs.append(np.asarray(logits[:, -1], np.float32))
        tok = jnp.argmax(logits[:, -1], axis=-1).astype(jnp.int32)[:, None]
        toks.append(np.asarray(tok))
        if i + 1 < NEW:
            logits, cache = decode(jp, cache, tok, jnp.int32(S + i))
    return np.concatenate(toks, axis=1), outs, jax.tree_util.tree_map(np.asarray, cache)


def _port_greedy(arch, B, S, opts=RunOpts(), pos_shift=0):
    _, _, m, p = _models(arch)
    batch = {"tokens": torch.as_tensor(_prompt(m.cfg.vocab_size, B, S))}
    if m.cfg.vision_tokens:
        batch["patches"] = torch.from_numpy(_patches(m.cfg, B))
    logits, cache = m.prefill(p, batch, S + NEW, opts)
    toks, outs = [], []
    for i in range(NEW):
        outs.append(_np(logits[:, -1]))
        tok = logits[:, -1].argmax(-1).to(torch.int32)[:, None]
        toks.append(tok.numpy())
        if i + 1 < NEW:
            logits, cache = m.decode_step(p, cache, tok, S + i + pos_shift, opts)
    return np.concatenate(toks, axis=1), outs, cache


@pytest.mark.parametrize("arch", [Q4, Q32, VLM])
@pytest.mark.parametrize("attn_impl", ["masked", "triangular", "flash"])
def test_prefill_decode_matches_jax(arch, attn_impl):
    """B=2, a 20-token prompt (after internvl2's 8 patch rows), 6 tokens."""
    jt, jl, jc = _jax_greedy(arch, 2, 20)
    tt, tl, tc = _port_greedy(arch, 2, 20, RunOpts(attn_impl=attn_impl, q_chunk=8,
                                                   kv_chunk=8))
    for i, (a, b) in enumerate(zip(tl, jl)):
        np.testing.assert_allclose(a, b, **TOL, err_msg=f"step {i}")
    assert np.array_equal(tt, jt)
    np.testing.assert_allclose(_np(tc["blocks"]["k"]), jc["blocks"]["k"], **TOL)
    assert np.array_equal(tc["blocks"]["pos_ids"].numpy(), jc["blocks"]["pos_ids"])


def test_vlm_pos_ids_run_without_a_hole():
    """After prefill and 5 decode steps the cache holds positions 0 ..
    8 + 20 + 4: the prefix, the prompt and every fed token."""
    cfg = get_arch(VLM).reduced()
    _, _, tc = _port_greedy(VLM, 2, 20)
    pos = tc["blocks"]["pos_ids"][0].numpy()
    n = cfg.vision_tokens + 20 + NEW - 1
    assert np.array_equal(pos[:n], np.arange(n)) and (pos[n:] == -1).all()


def test_dropping_the_vlm_decode_offset_fails():
    """A decode that forgot the vision prefix (it writes the new token's
    k/v over a live prefix slot, at RoPE angles 8 positions early) leaves
    the reference's logits: the comparison above catches it."""
    _, jl, _ = _jax_greedy(VLM, 2, 20)
    cfg = get_arch(VLM).reduced()
    _, tl, _ = _port_greedy(VLM, 2, 20, pos_shift=-cfg.vision_tokens)
    assert np.allclose(tl[0], jl[0], **TOL)          # prefill is untouched
    assert not all(np.allclose(a, b, **TOL) for a, b in zip(tl[1:], jl[1:]))


@pytest.mark.parametrize("attn_impl", ["masked", "triangular", "flash"])
def test_vlm_forward_train_text_logits_match_jax(attn_impl):
    jm, jp, m, p = _models(VLM)
    toks = _prompt(m.cfg.vocab_size, 2, 24, seed=4)
    patches = _patches(m.cfg, 2, seed=5)
    want, _ = jm.forward(jp, {"tokens": jnp.asarray(toks), "patches": jnp.asarray(patches)},
                         JaxRunOpts(q_chunk=16, kv_chunk=16))
    got, aux = m.forward(p, {"tokens": torch.from_numpy(toks),
                             "patches": torch.from_numpy(patches)},
                         RunOpts(attn_impl=attn_impl, q_chunk=16, kv_chunk=16))
    assert tuple(got.shape) == (2, 24, m.cfg.vocab_size) and float(aux) == 0.0
    np.testing.assert_allclose(_np(got), np.asarray(want), **TOL)


def _pack(pool, dense, pages, ps=16):
    """Copy a dense prefill cache's pages into pool pages (numpy, in place)."""
    for dk, pk in (("k", "k_pages"), ("v", "v_pages")):
        src = dense[dk][:, 0]
        L, T = src.shape[:2]
        pool[pk][:, pages[:T // ps]] = src.reshape(L, T // ps, ps, *src.shape[2:])


@pytest.mark.parametrize("arch", [Q4, Q32])
def test_decode_step_paged_matches_jax(arch):
    """Two lanes prefilled (17 and 30 tokens) into scattered pool pages,
    then 5 paged decode steps in both packages: logits at every step and
    the greedy streams."""
    jm, jp, m, p = _models(arch)
    lens, P, ps = (17, 30), 9, 16
    pages = ([6, 1], [3, 7, 0])
    table = np.full((2, 3), -1, np.int32)
    pool = {k: np.zeros((m.cfg.num_layers, P, ps, m.cfg.num_kv_heads, m.cfg.resolved_head_dim),
                        np.float32) for k in ("k_pages", "v_pages")}
    cur = []
    for b, n in enumerate(lens):
        toks = _prompt(m.cfg.vocab_size, 1, n, seed=10 + b)
        jl, dense = jm.prefill(jp, {"tokens": jnp.asarray(toks)}, n)
        _pack(pool, {k: np.asarray(v) for k, v in dense["blocks"].items()}, pages[b])
        table[b, :len(pages[b])] = pages[b]
        cur.append(int(jnp.argmax(jl[0, -1])))
    jcache = {"blocks": {k: jnp.asarray(v) for k, v in pool.items()}}
    tcache = {"blocks": {k: torch.from_numpy(v.copy()) for k, v in pool.items()}}
    jtok = ttok = np.asarray(cur, np.int32)[:, None]
    seq = np.asarray(lens, np.int32)
    for i in range(5):
        jl, jcache = jm.decode_step_paged(jp, jcache, jnp.asarray(jtok), jnp.asarray(seq),
                                          jnp.asarray(table))
        tl, tcache = m.decode_step_paged(p, tcache, torch.from_numpy(ttok),
                                         torch.from_numpy(seq), torch.from_numpy(table))
        np.testing.assert_allclose(_np(tl), np.asarray(jl), **TOL, err_msg=f"step {i}")
        jtok = np.asarray(jnp.argmax(jl[:, -1], axis=-1), np.int32)[:, None]
        ttok = tl[:, -1].argmax(-1).to(torch.int32)[:, None].numpy()
        assert np.array_equal(ttok, jtok), f"step {i}"
        seq = seq + 1


def test_dropping_the_bias_add_fails():
    """A ``_project_qkv`` without the bias add, everything else equal,
    misses the reference's prefill logits by far more than the tolerance:
    the nonzero biases make the comparisons above see the add."""
    def no_bias(params, xq, xkv, cfg):
        return project({k: v for k, v in params.items() if k not in ("bq", "bk", "bv")}, xq,
                       xkv, cfg)

    project = layers._project_qkv
    jt, jl, _ = _jax_greedy(Q4, 2, 20)
    with mock.patch.object(layers, "_project_qkv", no_bias):
        _, tl, _ = _port_greedy(Q4, 2, 20)
    assert not np.allclose(tl[0], jl[0], **TOL)
    assert float(np.abs(tl[0] - jl[0]).max()) > 100 * TOL["atol"]


# ---------------------------------------------------------------------------
# training: 3 steps against build_train_step(..., constrain=None)
# ---------------------------------------------------------------------------

def _train_both(arch, attn_impl, microbatches=2, n_steps=3):
    jcfg, cfg = _cfgs(arch)
    jstate0 = jax.tree_util.tree_map(
        np.asarray, jax_steps.init_train_state(jax_build_model(jcfg), jax.random.key(0)))
    jstate0 = jstate0._replace(params=_biased(jstate0.params))
    jtc = JaxTrainConfig(total_steps=10, warmup_steps=2, microbatches=microbatches)
    jstep = jax.jit(jax_steps.build_train_step(jax_build_model(jcfg), jtc,
                                               JaxLayout(attn_impl=attn_impl, q_chunk=16,
                                                         kv_chunk=16), constrain=None))
    tc = TrainConfig(total_steps=10, warmup_steps=2, microbatches=microbatches)
    step = steps.build_train_step(build_model(cfg), tc,
                                  ShardingLayout(attn_impl=attn_impl, q_chunk=16, kv_chunk=16))
    jds, ds = JaxSyntheticLM(256, 48, 4, seed=0), SyntheticLM(256, 48, 4, seed=0)
    jstate = jax.tree_util.tree_map(jnp.asarray, jstate0)
    state = train_state_from_jax(jstate0, cfg, "cpu")
    for i in range(n_steps):
        jstate, jm = jstep(jstate, {k: jnp.asarray(v) for k, v in jds.batch(i).items()})
        state, m = step(state, {k: torch.from_numpy(v) for k, v in ds.batch(i).items()})
        for k in ("loss", "grad_norm"):
            np.testing.assert_allclose(float(m[k]), float(jm[k]), rtol=1e-4, err_msg=f"{k} {i}")
    return jstate0, train_state_to_numpy(state), jax.tree_util.tree_map(np.asarray, jstate)


@pytest.mark.parametrize("arch,attn_impl", [(Q4, "masked"), (Q4, "flash"), (Q32, "flash"),
                                            (Q4, "triangular"), (Q32, "triangular")])
def test_train_step_matches_jax(arch, attn_impl):
    """Loss and grad norm at every step, then params (the bias leaves
    included, which must have moved from their start) and moments."""
    start, ours, ref = _train_both(arch, attn_impl)
    for tree, want in ((ours.params, ref.params), (ours.opt.m, ref.opt.m)):
        for a, b in zip(jax.tree_util.tree_leaves(tree), jax.tree_util.tree_leaves(want)):
            np.testing.assert_allclose(a, b, atol=1e-5, rtol=0)
    for key in ("bq", "bk", "bv"):
        moved = ours.params["blocks"]["attn"][key] - start.params["blocks"]["attn"][key]
        assert float(np.abs(moved).max()) > 0, key


# ---------------------------------------------------------------------------
# triangular blockwise attention
# ---------------------------------------------------------------------------

def _qkv(B, Sq, T, H, KVH, hd, seed):
    rng = np.random.RandomState(seed)
    return (rng.randn(B, Sq, H, hd).astype(np.float32),
            rng.randn(B, T, KVH, hd).astype(np.float32),
            rng.randn(B, T, KVH, hd).astype(np.float32))


# (Sq, T, q_chunk, kv_chunk, q_offset, window): chunk grids that divide,
# ragged ones (padded and masked), q chunks smaller and larger than kv
# chunks, a q offset (a prefill continuing a cache), and a window (the
# masked band path whatever ``impl`` says)
TRI_CASES = [
    (64, 64, 16, 16, 0, 0),
    (64, 64, 16, 32, 0, 0),
    (64, 64, 32, 16, 0, 0),
    (50, 50, 16, 16, 0, 0),
    (37, 61, 8, 16, 24, 0),
    (32, 96, 16, 32, 48, 0),
    (64, 64, 16, 16, 0, 24),
]


@pytest.mark.parametrize("case", TRI_CASES, ids=[str(c) for c in TRI_CASES])
def test_triangular_blockwise_attention_matches_jax(case):
    Sq, T, qc, kc, q_offset, window = case
    q, k, v = _qkv(2, Sq, T, 4, 2, 16, seed=Sq + T)
    kw = dict(causal=True, window=window, q_chunk=qc, kv_chunk=kc, q_offset=q_offset)
    want = jax_layers.blockwise_attention(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v),
                                          impl="triangular", **kw)
    tq, tk, tv = (torch.from_numpy(a) for a in (q, k, v))
    calls = {}

    def counted(impl):
        blocks = []
        real = layers._online_block

        def spy(*args):
            blocks.append(1)
            return real(*args)

        with mock.patch.object(layers, "_online_block", spy):
            out = layers.blockwise_attention(tq, tk, tv, impl=impl, **kw)
        calls[impl] = len(blocks)
        return out

    tri, masked = counted("triangular"), counted("masked")
    np.testing.assert_allclose(tri.numpy(), np.asarray(want), atol=1e-5, rtol=0)
    assert torch.equal(tri, masked)
    n_q, n_kv = -(-Sq // qc), -(-T // kc)
    if window:
        assert calls["triangular"] == calls["masked"] == 0   # the band path
    else:
        want_calls = sum(min(-(-((i + 1) * qc + q_offset) // kc), n_kv) for i in range(n_q))
        assert calls["masked"] == n_q * n_kv and calls["triangular"] == want_calls
        assert want_calls < n_q * n_kv


def test_triangular_non_causal_takes_the_masked_path():
    q, k, v = _qkv(1, 40, 40, 4, 4, 16, seed=9)
    kw = dict(causal=False, q_chunk=16, kv_chunk=16)
    want = jax_layers.blockwise_attention(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v),
                                          impl="triangular", **kw)
    tq, tk, tv = (torch.from_numpy(a) for a in (q, k, v))
    tri = layers.blockwise_attention(tq, tk, tv, impl="triangular", **kw)
    np.testing.assert_allclose(tri.numpy(), np.asarray(want), atol=1e-5, rtol=0)
    assert torch.equal(tri, layers.blockwise_attention(tq, tk, tv, impl="masked", **kw))


# ---------------------------------------------------------------------------
# what stays refused
# ---------------------------------------------------------------------------

def _variant_prefill_matches_jax(**change):
    """Reduced qwen1.5-4b with ``change`` applied in both packages, f32,
    biases drawn: the port builds it and its prefill logits (B=2, S=20)
    match the reference's."""
    jcfg, cfg = (dataclasses.replace(c, **change) for c in _cfgs(Q4))
    jm, m = jax_build_model(jcfg), build_model(cfg)
    tree = _biased(jax.tree_util.tree_map(np.asarray, jm.init(jax.random.key(0))))
    assert _spec_fields(m.specs) == _spec_fields(jm.specs)
    toks = _prompt(cfg.vocab_size, 2, 20)
    want, _ = jm.prefill(jax.tree_util.tree_map(jnp.asarray, tree),
                         {"tokens": jnp.asarray(toks)}, 20)
    got, _ = m.prefill(params_from_jax(tree, cfg, "cpu"), {"tokens": torch.from_numpy(toks)},
                       20)
    np.testing.assert_allclose(_np(got), np.asarray(want), **TOL)


@pytest.mark.parametrize("field", ["tie_embeddings", "embed_scale", "encoder_layers"])
def test_later_slices_still_refuse(field):
    """Tied and scaled embeddings (ported with gemma-7b) build and match the
    reference. Encoders (whisper-tiny, held in tests/test_torch_whisper.py)
    build too; what an encoder-decoder still may not do is page its cache,
    as in the reference, so the plan modes' engine refuses it (its dense
    ``--plan``, held in tests/test_torch_whisper_plan.py, serves it)."""
    if field == "encoder_layers":
        cfg = get_arch("whisper-tiny").reduced()
        assert "encoder" in build_model(cfg).specs
        with pytest.raises(NotImplementedError, match="DENSE"):
            build_model(cfg).paged_cache_specs(8)
        with pytest.raises(NotImplementedError, match="DENSE"):
            from repro_torch.launch.serve import serve_plan
            serve_plan(build_model(cfg), None, np.zeros((1, 4), np.int32), 2, [1], engine=True)
    else:
        _variant_prefill_matches_jax(**{field: True})


def test_geglu_and_dots_remat_still_refuse():
    """``remat="dots"`` runs since it was ported (held against the
    reference's policy by ``tests/test_torch_remat_dots.py``) and gives the
    logits ``full`` gives; a remat the reference lacks still refuses
    (GeGLU, ported with gemma-7b, is held by ``test_geglu_matches_jax``)."""
    _, _, m, p = _models(Q4)
    tokens = {"tokens": torch.zeros((1, 4), dtype=torch.int32)}
    full, _ = m.forward(p, tokens, RunOpts(remat="full"))
    dots, _ = m.forward(p, tokens, RunOpts(remat="dots"))
    assert torch.equal(full, dots)
    with pytest.raises(NotImplementedError, match="remat"):
        m.forward(p, tokens, RunOpts(remat="offload"))


def test_geglu_matches_jax():
    _variant_prefill_matches_jax(mlp_activation="gelu")
