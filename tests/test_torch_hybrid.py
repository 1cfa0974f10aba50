"""The port's hybrid (Hymba) serving path against the JAX package's, on
the CPU: specs and cache specs, sliding-window blockwise attention, the
ring-buffer ``decode_attention``, reduced hymba-1.5b ``prefill`` +
``decode_step`` (and dense qwen3-4b's ``decode_step``), the serve
launcher's greedy loop, and the serving dtypes of the params.

The oracle is the JAX ``Model`` with default ``RunOpts()`` under
``jax.jit`` and no mesh (the JAX ``DecodeEngine`` and ``host_main`` need a
mesh constraint this JAX version rejects). Params come from
``Model.init(jax.random.key(0))`` and go across with ``params_from_jax``;
prompts are made with numpy from a seed. Tolerances: f32 atol=rtol=1e-4
(XLA and torch sum matmuls in different orders) with greedy streams
identical; bf16 top-1 equal at every step under teacher forcing.
"""
import dataclasses
import functools
from types import SimpleNamespace

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.config import get_arch as jax_get_arch
from repro.models import build_model as jax_build_model
from repro.models import layers as jax_layers
from repro.models import transformer as jax_transformer
from repro_torch.config import BlockKind, ShardingLayout, get_arch
from repro_torch.kernels.flash_attention import attention_ref
from repro_torch.launch import serve as serve_launcher
from repro_torch.models import RunOpts, build_model, layers, transformer
from repro_torch.models.convert import cache_from_jax, cache_to_numpy, params_from_jax

F32, BF16 = "float32", "bfloat16"
HYMBA, QWEN = "hymba-1.5b", "qwen3-4b"
NEW = 16


def _np(x):
    return x.float().numpy() if isinstance(x, torch.Tensor) else np.asarray(x, np.float32)


def _spec_fields(tree):
    """A spec tree as nested dicts of the reference's ParamSpec fields."""
    if isinstance(tree, dict):
        return {k: _spec_fields(v) for k, v in tree.items()}
    return (tuple(tree.shape), tuple(tree.axes), tree.init, tree.scale, tree.dtype)


# ---------------------------------------------------------------------------
# specs
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("arch", [HYMBA, QWEN])
@pytest.mark.parametrize("reduced", [False, True])
def test_specs_match_jax(arch, reduced):
    pick = (lambda c: c.reduced()) if reduced else (lambda c: c)
    cfg, jcfg = pick(get_arch(arch)), pick(jax_get_arch(arch))
    assert _spec_fields(build_model(cfg).specs) == _spec_fields(jax_build_model(jcfg).specs)
    assert build_model(cfg).param_count() == jax_build_model(jcfg).param_count()
    for batch, seq in ((2, 36), (8, 4128)):
        assert (_spec_fields(transformer.cache_specs(cfg, batch, seq))
                == _spec_fields(jax_transformer.cache_specs(jcfg, batch, seq)))
        assert transformer.cache_len_for(cfg, seq) == jax_transformer.cache_len_for(jcfg, seq)


def test_hymba_full_width_shape():
    cfg = get_arch(HYMBA)
    assert (cfg.num_layers, cfg.d_model, cfg.num_heads, cfg.num_kv_heads, cfg.window) == (
        32, 1600, 25, 5, 1024)
    assert transformer.cache_len_for(cfg, 4096 + 32) == 1024
    assert abs(build_model(cfg).param_count() / 1e9 - 1.662) < 1e-3


def test_init_cache_matches_jax():
    cfg, jcfg = get_arch(HYMBA).reduced(), jax_get_arch(HYMBA).reduced()
    tc = cache_to_numpy(build_model(cfg).init_cache(2, 36, "cpu"))
    jc = jax.tree_util.tree_map(np.asarray, jax_build_model(jcfg).init_cache(2, 36))
    flat = jax.tree_util.tree_leaves_with_path(jc)
    assert len(flat) == len(jax.tree_util.tree_leaves(tc))
    for path, a in flat:
        b = functools.reduce(lambda t, k: t[k.key], path, tc)
        assert np.array_equal(a, b), path
    assert (tc["blocks"]["pos_ids"] == -1).all()


# ---------------------------------------------------------------------------
# attention
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("S,q_chunk,kv_chunk", [(12, 16, 16), (48, 8, 16), (37, 8, 16)])
def test_blockwise_attention_window_matches_jax(S, q_chunk, kv_chunk):
    """Window 8: one fused block (S=12), the static kv band per q chunk
    with S past it (S=48), and the ragged pad path (S=37)."""
    rng = np.random.RandomState(S)
    q = rng.randn(2, S, 4, 32).astype(np.float32)
    k = rng.randn(2, S, 2, 32).astype(np.float32)
    v = rng.randn(2, S, 2, 32).astype(np.float32)
    kw = dict(causal=True, window=8, q_chunk=q_chunk, kv_chunk=kv_chunk)
    out = layers.blockwise_attention(*(torch.from_numpy(a) for a in (q, k, v)), **kw)
    ref = jax_layers.blockwise_attention(*(jnp.asarray(a) for a in (q, k, v)), **kw)
    np.testing.assert_allclose(_np(out), _np(ref), atol=1e-5, rtol=1e-5)
    dense = attention_ref(*(torch.from_numpy(a) for a in (q, k, v)), causal=True, window=8)
    np.testing.assert_allclose(_np(out), _np(dense), atol=1e-5, rtol=1e-5)


def test_decode_attention_ring_buffer_matches_jax():
    """Reduced hymba: T=16 slots, window 8. 40 tokens wrap the ring twice,
    and the cache holds more than the window, so the mask must cut."""
    cfg = dataclasses.replace(get_arch(HYMBA).reduced(), dtype=F32)
    jcfg = dataclasses.replace(jax_get_arch(HYMBA).reduced(), dtype=F32)
    jparams = jax_build_model(jcfg).init(jax.random.key(0))
    jp = jax.tree_util.tree_map(lambda a: a[0], jparams["blocks"]["attn"])
    tp = transformer.layer_slice(
        params_from_jax(jax.tree_util.tree_map(np.asarray, jparams), cfg, "cpu")["blocks"], 0
    )["attn"]
    T = transformer.cache_len_for(cfg, 40)
    assert T == 16 and cfg.window == 8
    spec = layers.make_cache_specs(cfg, 2, T)
    tcache = {k: torch.zeros(s.shape, dtype=getattr(torch, s.dtype)) for k, s in spec.items()}
    tcache["pos_ids"].fill_(-1)
    jcache = {k: jnp.asarray(v.numpy()) for k, v in tcache.items()}
    step = jax.jit(lambda p, c, x, pos: jax_layers.decode_attention(p, c, x, pos, jcfg))
    rng = np.random.RandomState(0)
    for pos in range(40):
        x = rng.randn(2, 1, cfg.d_model).astype(np.float32)
        jy, jcache = step(jp, jcache, jnp.asarray(x), jnp.int32(pos))
        ty, tcache = layers.decode_attention(tp, tcache, torch.from_numpy(x), pos, cfg)
        np.testing.assert_allclose(_np(ty), _np(jy), atol=1e-4, rtol=1e-4, err_msg=str(pos))
    for key in ("k", "v"):
        np.testing.assert_allclose(_np(tcache[key]), _np(jcache[key]), atol=1e-5, rtol=1e-5)
    assert np.array_equal(tcache["pos_ids"].numpy(), np.asarray(jcache["pos_ids"]))
    assert sorted(tcache["pos_ids"].tolist()) == list(range(24, 40))


# ---------------------------------------------------------------------------
# reduced models: prefill + decode_step against the JAX Model
# ---------------------------------------------------------------------------

@functools.lru_cache(maxsize=None)
def _jax_params(arch):
    cfg = jax_get_arch(arch).reduced()
    return jax.tree_util.tree_map(np.asarray, jax_build_model(cfg).init(jax.random.key(0)))


def _prompt(vocab, B, S, seed=0):
    return np.random.RandomState(seed).randint(0, vocab, (B, S)).astype(np.int32)


@functools.lru_cache(maxsize=None)
def _jax_greedy(arch, dtype, B, S, feed=None):
    """The JAX greedy loop (as ``host_main`` runs it): jitted prefill, then
    jitted decode_step at positions S, S+1, ...; ``feed`` (a tuple of
    per-step token rows) replaces the sampled tokens (teacher forcing).
    Returns (tokens (B, NEW), per-step logits, final cache), numpy."""
    cfg = dataclasses.replace(jax_get_arch(arch).reduced(), dtype=dtype)
    model = jax_build_model(cfg)
    params = jax.tree_util.tree_map(jnp.asarray, _jax_params(arch))
    prefill = jax.jit(lambda p, b: model.prefill(p, b, S + NEW))
    decode = jax.jit(model.decode_step)
    logits, cache = prefill(params, {"tokens": jnp.asarray(_prompt(cfg.vocab_size, B, S))})
    toks, outs = [], []
    for i in range(NEW):
        outs.append(np.asarray(logits[:, -1], np.float32))
        tok = jnp.argmax(logits[:, -1], axis=-1).astype(jnp.int32)[:, None]
        toks.append(np.asarray(tok))
        if feed is not None:
            tok = jnp.asarray(np.asarray(feed[i], np.int32)[:, None])
        if i + 1 < NEW:
            logits, cache = decode(params, cache, tok, jnp.int32(S + i))
    cache = jax.tree_util.tree_map(lambda a: np.asarray(a, np.float32)
                                   if a.dtype != jnp.int32 else np.asarray(a), cache)
    return np.concatenate(toks, axis=1), outs, cache


def _port_greedy(arch, dtype, B, S, opts=RunOpts(), feed=None):
    cfg = dataclasses.replace(get_arch(arch).reduced(), dtype=dtype)
    model = build_model(cfg)
    params = params_from_jax(_jax_params(arch), cfg, "cpu",
                             dtype=torch.bfloat16 if dtype == BF16 else None)
    logits, cache = model.prefill(
        params, {"tokens": torch.as_tensor(_prompt(cfg.vocab_size, B, S))}, S + NEW, opts)
    toks, outs = [], []
    for i in range(NEW):
        outs.append(_np(logits[:, -1]))
        tok = logits[:, -1].argmax(-1).to(torch.int32)[:, None]
        toks.append(tok.numpy())
        if feed is not None:
            tok = torch.as_tensor(np.asarray(feed[i], np.int32)[:, None])
        if i + 1 < NEW:
            logits, cache = model.decode_step(params, cache, tok, S + i, opts)
    return np.concatenate(toks, axis=1), outs, cache_to_numpy(cache)


def _assert_caches_close(tc, jc):
    flat = jax.tree_util.tree_leaves_with_path(jc)
    assert len(flat) == len(jax.tree_util.tree_leaves(tc))
    for path, a in flat:
        b = functools.reduce(lambda t, k: t[k.key], path, tc)
        assert b.shape == a.shape, path
        if path[-1].key == "pos_ids":
            assert np.array_equal(a, b), path
        else:
            np.testing.assert_allclose(b, a, atol=1e-4, rtol=1e-4, err_msg=str(path))


@pytest.mark.parametrize("S", [5, 20])
@pytest.mark.parametrize("attn_impl", ["masked", "flash"])
def test_hymba_prefill_decode_f32_matches_jax(S, attn_impl):
    """S=5 fills part of the T=16 ring (the padded cache branch); S=20 is
    longer than T (the ring-ordered branch). 16 decode steps wrap the ring."""
    jt, jl, jc = _jax_greedy(HYMBA, F32, 2, S)
    tt, tl, tc = _port_greedy(HYMBA, F32, 2, S, RunOpts(attn_impl=attn_impl))
    for i, (a, b) in enumerate(zip(tl, jl)):
        np.testing.assert_allclose(a, b, atol=1e-4, rtol=1e-4, err_msg=f"step {i}")
    assert np.array_equal(tt, jt)
    assert set(tc["blocks"]) == {"k", "v", "pos_ids", "ssm"}
    assert set(tc["blocks"]["ssm"]) == {"conv", "h"}
    _assert_caches_close(tc, jc)


def test_hymba_bf16_top1_matches_jax():
    """bf16: both stacks fed the JAX stream agree on top-1 at every step."""
    jt, _, _ = _jax_greedy(HYMBA, BF16, 2, 20)
    feed = tuple(map(tuple, jt.T))
    j_tops, _, _ = _jax_greedy(HYMBA, BF16, 2, 20, feed=feed)
    t_tops, _, _ = _port_greedy(HYMBA, BF16, 2, 20, feed=feed)
    assert np.array_equal(t_tops, j_tops)


def test_dense_decode_step_f32_matches_jax():
    jt, jl, jc = _jax_greedy(QWEN, F32, 2, 20)
    tt, tl, tc = _port_greedy(QWEN, F32, 2, 20)
    for i, (a, b) in enumerate(zip(tl, jl)):
        np.testing.assert_allclose(a, b, atol=1e-4, rtol=1e-4, err_msg=f"step {i}")
    assert np.array_equal(tt, jt)
    _assert_caches_close(tc, jc)


def test_cache_round_trip_from_jax():
    """A JAX prefill cache (bf16 k/v and conv, f32 h, int32 pos_ids) comes
    across exactly, and a decode step from it matches JAX's."""
    jcfg = jax_get_arch(HYMBA).reduced()
    cfg = get_arch(HYMBA).reduced()
    jm, m = jax_build_model(jcfg), build_model(cfg)
    jp = jax.tree_util.tree_map(jnp.asarray, _jax_params(HYMBA))
    toks = _prompt(cfg.vocab_size, 2, 20)
    _, jcache = jax.jit(lambda p, b: jm.prefill(p, b, 20 + NEW))(jp, {"tokens": toks})
    tcache = cache_from_jax(jax.tree_util.tree_map(np.asarray, jcache), cfg, 2, 20 + NEW, "cpu")
    assert tcache["blocks"]["k"].dtype == tcache["blocks"]["ssm"]["conv"].dtype == torch.bfloat16
    assert tcache["blocks"]["ssm"]["h"].dtype == torch.float32
    assert tcache["blocks"]["pos_ids"].dtype == torch.int32
    back = cache_to_numpy(tcache)
    for path, a in jax.tree_util.tree_leaves_with_path(jcache):
        b = functools.reduce(lambda t, k: t[k.key], path, back)
        assert np.array_equal(np.asarray(a, b.dtype), b), path
    tok = np.asarray([[3], [7]], np.int32)
    jl, _ = jax.jit(jm.decode_step)(jp, jcache, jnp.asarray(tok), jnp.int32(20))
    tp = params_from_jax(_jax_params(HYMBA), cfg, "cpu", dtype=torch.bfloat16)
    tl, _ = m.decode_step(tp, tcache, torch.as_tensor(tok), 20)
    np.testing.assert_allclose(_np(tl), _np(jl), atol=2e-2, rtol=2e-2)
    assert np.array_equal(tl[:, -1].argmax(-1).numpy(), np.asarray(jnp.argmax(jl[:, -1], -1)))


# ---------------------------------------------------------------------------
# the serve launcher
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("attn_impl", ["flash", "masked"])
def test_greedy_serve_matches_jax_greedy_loop(attn_impl):
    """The launcher's loop on the CPU (the kernels' plain versions) gives
    the JAX greedy loop's stream, B=2, S=20, 16 tokens."""
    jt, jl, _ = _jax_greedy(HYMBA, F32, 2, 20)
    cfg = dataclasses.replace(get_arch(HYMBA).reduced(), dtype=F32)
    model = build_model(cfg)
    params = params_from_jax(_jax_params(HYMBA), cfg, "cpu")
    res = serve_launcher.greedy_serve(
        model, params, torch.as_tensor(_prompt(cfg.vocab_size, 2, 20)), NEW,
        ShardingLayout(attn_impl=attn_impl))
    assert res.tokens.dtype == torch.int32 and tuple(res.tokens.shape) == (2, NEW)
    assert np.array_equal(res.tokens.numpy(), jt)
    assert len(res.logits) == NEW and res.decode_steps == NEW - 1
    for a, b in zip(res.logits, jl):
        np.testing.assert_allclose(_np(a), b, atol=1e-4, rtol=1e-4)
    assert res.prefill_seconds > 0 and res.decode_seconds > 0


def _args(**kw):
    base = dict(arch=HYMBA, batch=2, prompt_len=20, new_tokens=4, reduced=True,
                device="cpu", seed=0, int8_cache=False, plan="", engine=False, trace="")
    return SimpleNamespace(**{**base, **kw})


def test_host_main_serves_on_cpu(capsys):
    out = serve_launcher.host_main(_args())
    assert out["arch"] == "hymba-1.5b-reduced" and out["device"] == "cpu"
    assert len(out["first_row"]) == 4
    assert all(0 <= t < 256 for t in out["first_row"])
    assert '"serve done"' in capsys.readouterr().out


@pytest.mark.parametrize("flag", [dict(), dict(plan="8,4"), dict(plan="8,4", engine=True),
                                  dict(trace="t.jsonl")])
def test_host_main_refuses_unported_modes(flag):
    """``--plan``, ``--engine`` and ``--trace`` are ported; the int8 KV
    cache is not, and every mode refuses it."""
    with pytest.raises(NotImplementedError, match="not ported"):
        serve_launcher._dispatch(_args(int8_cache=True, **flag))


def test_serve_launcher_refuses_missing_cuda(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA"):
        serve_launcher.host_main(_args(device="cuda"))
    with pytest.raises(RuntimeError, match="CUDA"):
        build_model(get_arch(HYMBA).reduced()).init_cache(2, 8)


# ---------------------------------------------------------------------------
# what the port refuses, and the serving dtypes
# ---------------------------------------------------------------------------

def test_hybrid_training_and_paged_decode_refuse():
    cfg = get_arch(HYMBA).reduced()
    m = build_model(cfg)
    params = m.init(torch.Generator().manual_seed(0), "cpu")
    batch = {"tokens": torch.zeros((1, 8), dtype=torch.int32)}
    with pytest.raises(NotImplementedError, match="DENSE"):
        m.forward_hidden(params, batch)
    with pytest.raises(NotImplementedError, match="DENSE"):
        m.forward(params, batch)
    with pytest.raises(NotImplementedError, match="DENSE"):
        m.paged_cache_specs(8)
    with pytest.raises(NotImplementedError):
        build_model(dataclasses.replace(cfg, block=BlockKind.MOE))
    with pytest.raises(NotImplementedError, match="int8"):
        m.cache_specs(2, 8, int8=True)


def _dtypes(tree, prefix=""):
    if isinstance(tree, dict):
        return {k: v for key, sub in tree.items() for k, v in _dtypes(sub, f"{prefix}{key}.").items()}
    return {prefix[:-1]: tree.dtype}


F32_LEAVES = {"blocks.mamba.A_log", "blocks.mamba.x_proj", "blocks.mamba.dt_proj"}


def test_serving_dtype_keeps_f32_leaves():
    """Stored for bf16 serving, the leaves the Mamba block reads in f32 stay
    f32 (by ``Model.init`` and by ``params_from_jax``); the matrices the
    model casts per use are bf16; norm scales and biases stay f32."""
    cfg = get_arch(HYMBA).reduced()
    made = build_model(cfg).init(torch.Generator().manual_seed(0), "cpu", torch.bfloat16)
    carried = params_from_jax(_jax_params(HYMBA), cfg, "cpu", dtype=torch.bfloat16)
    for params in (made, carried):
        dt = _dtypes(params)
        assert all(dt[k] == torch.float32 for k in F32_LEAVES)
        bf16 = {k for k, v in dt.items() if v == torch.bfloat16}
        assert bf16 == {"embed", "lm_head", "blocks.attn.wq", "blocks.attn.wk", "blocks.attn.wv",
                        "blocks.attn.wo", "blocks.mamba.in_proj", "blocks.mamba.conv_w",
                        "blocks.mamba.out_proj", "blocks.mlp.wi_gate", "blocks.mlp.wi_up",
                        "blocks.mlp.wo"}


def test_serving_dtype_of_dense_params_unchanged():
    """qwen3-4b's serving params: every matrix bf16, every norm scale f32,
    as before the keep-f32 rule."""
    cfg = get_arch(QWEN).reduced()
    made = build_model(cfg).init(torch.Generator().manual_seed(0), "cpu", torch.bfloat16)
    carried = params_from_jax(_jax_params(QWEN), cfg, "cpu", dtype=torch.bfloat16)
    for params in (made, carried):
        assert _dtypes(params) == {
            "embed": torch.bfloat16, "final_norm.scale": torch.float32,
            "lm_head": torch.bfloat16, "blocks.ln1.scale": torch.float32,
            "blocks.attn.wq": torch.bfloat16, "blocks.attn.wk": torch.bfloat16,
            "blocks.attn.wv": torch.bfloat16, "blocks.attn.wo": torch.bfloat16,
            "blocks.attn.q_norm": torch.float32, "blocks.attn.k_norm": torch.float32,
            "blocks.ln2.scale": torch.float32, "blocks.mlp.wi_gate": torch.bfloat16,
            "blocks.mlp.wi_up": torch.bfloat16, "blocks.mlp.wo": torch.bfloat16}
