"""gemma-7b in the port against the JAX package, on the CPU: its specs and
parameter count (tied embeddings: no ``lm_head``), the GeGLU MLP (tanh
GELU, as ``jax.nn.gelu`` computes by default), the plain attention kernels
at head dim 256 against the Pallas kernels in interpret mode, and reduced
gemma (head dim set back to 256: ``reduced()`` gives 32) through prefill,
decode, the paged decode, the engine and 3 training steps.

The embedding scale is a float32 scalar, as in the reference, where it
promotes a bf16 model's residual stream to f32: the bf16 tests hold the
residual's dtype at every entry point and the logits against the
reference. Inputs are made with numpy from a seed; weights come from the
reference's ``init`` (``jax.random.key(0)``) through ``params_from_jax``.
Tolerances: f32 logits atol=rtol=1e-4 with identical greedy streams (XLA
and torch sum in different orders), the MLP and the embedding's gradient
1e-5, training loss and grad norm rtol 1e-4, params and first moments
atol 1e-5; the kernels the reference's own (``tests/test_kernels.py``:
2e-5 f32 forward, 1e-4 f32 backward, 2e-2 bf16); bf16 logits 2e-2 in
units of their standard deviation (tied logits are ~14 wide), with the
same top-1.
"""
import dataclasses
import functools
from unittest import mock

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch.nn.functional as F

from repro.config import ShardingLayout as JaxLayout
from repro.config import TrainConfig as JaxTrainConfig
from repro.config import get_arch as jax_get_arch
from repro.data import SyntheticLM as JaxSyntheticLM
from repro.kernels.flash_attention import flash_attention as jax_flash
from repro.kernels.flash_attention.kernel_bwd import flash_attention_bwd as jax_bwd
from repro.kernels.paged_attention import paged_decode_attention as jax_paged
from repro.models import build_model as jax_build_model
from repro.models import layers as jax_layers
from repro.models import transformer as jax_transformer
from repro.train import steps as jax_steps
from repro_torch.config import ShardingLayout, TrainConfig, get_arch
from repro_torch.data import SyntheticLM
from repro_torch.kernels.flash_attention import attention_bwd_ref, attention_fwd_ref
from repro_torch.kernels.paged_attention import paged_attention_ref
from repro_torch.models import RunOpts, build_model, layers, transformer
from repro_torch.models.convert import params_from_jax, train_state_from_jax, train_state_to_numpy
from repro_torch.serve import DecodeEngine, Request
from repro_torch.train import steps
from test_torch_engine import NEW as ENGINE_NEW
from test_torch_engine import _jax_engine_oracle

GEMMA = "gemma-7b"
HD = 256
NEW = 6
TOL = dict(atol=1e-4, rtol=1e-4)
BF16_TOL = dict(atol=2e-2, rtol=2e-2)


def kernel_tol(dtype, backward=False):
    if dtype == jnp.bfloat16:
        return BF16_TOL
    return dict(atol=1e-4, rtol=1e-4) if backward else dict(atol=2e-5, rtol=2e-5)


def _np(x):
    return x.float().numpy() if isinstance(x, torch.Tensor) else np.asarray(x, np.float32)


def _spec_fields(tree):
    if isinstance(tree, dict):
        return {k: _spec_fields(v) for k, v in tree.items()}
    return (tuple(tree.shape), tuple(tree.axes), tree.init, tree.scale, tree.dtype)


def _cfgs(dtype="float32"):
    """Reduced gemma in both packages, head dim 256."""
    pick = lambda c: dataclasses.replace(c.reduced(), head_dim=HD, dtype=dtype)
    return pick(jax_get_arch(GEMMA)), pick(get_arch(GEMMA))


@functools.lru_cache(maxsize=None)
def _jax_params():
    jcfg, _ = _cfgs()
    return jax.tree_util.tree_map(np.asarray, jax_build_model(jcfg).init(jax.random.key(0)))


def _models(dtype="float32"):
    """(JAX model, JAX params, port model, port params); params f32."""
    jcfg, cfg = _cfgs(dtype)
    tree = _jax_params()
    return (jax_build_model(jcfg), jax.tree_util.tree_map(jnp.asarray, tree),
            build_model(cfg), params_from_jax(tree, cfg, "cpu"))


def _prompt(vocab, B, S, seed=0):
    return np.random.RandomState(seed).randint(0, vocab, (B, S)).astype(np.int32)


# ---------------------------------------------------------------------------
# config, specs
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("reduced", [False, True])
def test_specs_and_param_count_match_jax(reduced):
    cfg, jcfg = get_arch(GEMMA), jax_get_arch(GEMMA)
    if reduced:
        jcfg, cfg = _cfgs()
    assert dataclasses.asdict(cfg) == dataclasses.asdict(jcfg)
    model, jmodel = build_model(cfg), jax_build_model(jcfg)
    assert _spec_fields(model.specs) == _spec_fields(jmodel.specs)
    assert "lm_head" not in model.specs
    assert model.param_count() == jmodel.param_count() == jcfg.param_count()
    if not reduced:
        assert model.param_count() == 8_537_680_896
    assert (_spec_fields(transformer.paged_cache_specs(cfg, 9))
            == _spec_fields(jax_transformer.paged_cache_specs(jcfg, 9)))


def test_unembed_is_a_view_of_the_embedding():
    _, _, m, p = _models()
    w = m.unembed_weight(p)
    assert w.shape == (m.cfg.d_model, m.cfg.vocab_size)
    assert w.data_ptr() == p["embed"].data_ptr() and torch.equal(w, p["embed"].T)


# ---------------------------------------------------------------------------
# GeGLU
# ---------------------------------------------------------------------------

def _mlp_inputs(seed=0):
    jcfg, cfg = _cfgs()
    rng = np.random.RandomState(seed)
    d, f = cfg.d_model, cfg.d_ff
    w = {k: (rng.randn(*s) / np.sqrt(s[0])).astype(np.float32)
         for k, s in (("wi_gate", (d, f)), ("wi_up", (d, f)), ("wo", (f, d)))}
    x = (2.0 * rng.randn(2, 7, d)).astype(np.float32)
    want = jax_layers.mlp({k: jnp.asarray(v) for k, v in w.items()}, jnp.asarray(x), jcfg)
    return cfg, {k: torch.from_numpy(v) for k, v in w.items()}, torch.from_numpy(x), \
        np.asarray(want)


def test_geglu_mlp_matches_jax():
    cfg, w, x, want = _mlp_inputs()
    assert cfg.mlp_activation == "gelu" and cfg.gated_mlp
    np.testing.assert_allclose(layers.mlp(w, x, cfg).numpy(), want, atol=1e-5, rtol=1e-5)


def test_erf_gelu_mutant_fails():
    """The erf GELU (``F.gelu``'s default) in place of the tanh form misses
    the reference's MLP by far more than the tolerance."""
    cfg, w, x, want = _mlp_inputs()
    erf = lambda t, kind: F.gelu(t) if kind == "gelu" else F.silu(t)
    with mock.patch.object(layers, "_act", erf):
        got = layers.mlp(w, x, cfg).numpy()
    assert not np.allclose(got, want, atol=1e-5, rtol=1e-5)
    assert float(np.abs(got - want).max()) > 10 * 1e-5


# ---------------------------------------------------------------------------
# the plain kernels at head dim 256 against the Pallas kernels (interpret)
# ---------------------------------------------------------------------------

def _qkv(B, Sq, Skv, H, KVH, seed, dtype):
    rng = np.random.RandomState(seed)
    shapes = [(B, Sq, H, HD), (B, Skv, KVH, HD), (B, Skv, KVH, HD), (B, Sq, H, HD)]
    arrs = [rng.randn(*s).astype(np.float32) for s in shapes]
    return ([jnp.asarray(a, dtype) for a in arrs],
            [torch.from_numpy(a).to(getattr(torch, jnp.dtype(dtype).name)) for a in arrs])


# B, S, H, KVH, causal window, dtype: GQA, MQA with a window, in both dtypes
FLASH_CASES = [(1, 128, 4, 2, 0, jnp.float32), (2, 128, 4, 1, 32, jnp.float32),
               (1, 128, 4, 2, 0, jnp.bfloat16), (2, 128, 4, 1, 32, jnp.bfloat16)]


@pytest.mark.parametrize("B,S,H,KVH,window,dtype", FLASH_CASES)
def test_flash_fwd_plain_matches_pallas_interpret_hd256(B, S, H, KVH, window, dtype):
    (qj, kj, vj, _), (qt, kt, vt, _) = _qkv(B, S, S, H, KVH, 11 + window, dtype)
    out = jax_flash(qj, kj, vj, True, window, 0, 128, 128, True)
    got, _ = attention_fwd_ref(qt, kt, vt, causal=True, window=window)
    np.testing.assert_allclose(_np(got), np.asarray(out, np.float32), **kernel_tol(dtype))


@pytest.mark.parametrize("B,S,H,KVH,window,dtype", FLASH_CASES)
def test_flash_bwd_plain_matches_pallas_interpret_hd256(B, S, H, KVH, window, dtype):
    (_, _, _, _), (q, k, v, do) = _qkv(B, S, S, H, KVH, 21 + window, dtype)
    kw = dict(causal=True, window=window)
    o, lse = attention_fwd_ref(q, k, v, **kw)
    head_major = lambda t: jnp.asarray(t.transpose(1, 2).float().numpy(), dtype)
    dq, dk, dv = jax_bwd(head_major(q), head_major(k), head_major(v), head_major(o),
                         jnp.asarray(lse.numpy()), head_major(do), **kw, block_q=64,
                         block_k=64, interpret=True)
    got = attention_bwd_ref(q, k, v, o, lse, do, **kw)
    for name, g, w in zip(("dq", "dk", "dv"), got, (dq, dk, dv)):
        np.testing.assert_allclose(_np(g), np.moveaxis(np.asarray(w, np.float32), 1, 2),
                                   **kernel_tol(dtype, backward=True), err_msg=name)


@pytest.mark.parametrize("H,KVH,lens,dtype", [(4, 4, [64, 33], jnp.float32),
                                              (8, 2, [1, 50], jnp.float32),
                                              (4, 4, [64, 7], jnp.bfloat16)])
def test_paged_plain_matches_pallas_interpret_hd256(H, KVH, lens, dtype):
    rng = np.random.RandomState(5)
    B, ps, mb = len(lens), 16, 4
    num_pages = B * mb + 1
    arrs = [rng.randn(B, H, HD), rng.randn(num_pages, ps, KVH, HD),
            rng.randn(num_pages, ps, KVH, HD)]
    perm = rng.permutation(B * mb)
    table = np.full((B, mb), -1, np.int32)
    for b, n in enumerate(lens):
        table[b, :-(-n // ps)] = perm[b * mb: b * mb - (-n // ps)]
    sl = np.asarray(lens, np.int32)
    tdt = getattr(torch, jnp.dtype(dtype).name)
    jx = [jnp.asarray(a.astype(np.float32), dtype) for a in arrs] + [jnp.asarray(table),
                                                                   jnp.asarray(sl)]
    tx = [torch.from_numpy(a.astype(np.float32)).to(tdt) for a in arrs] + [
        torch.from_numpy(table), torch.from_numpy(sl)]
    want = jax_paged(*jx, interpret=True)
    np.testing.assert_allclose(_np(paged_attention_ref(*tx)), np.asarray(want, np.float32),
                               **kernel_tol(dtype))


# ---------------------------------------------------------------------------
# reduced gemma (head dim 256), f32: prefill, decode, paged decode, engine
# ---------------------------------------------------------------------------

@functools.lru_cache(maxsize=None)
def _jax_greedy(B, S):
    jm, jp, _, _ = _models()
    logits, cache = jax.jit(lambda p, b: jm.prefill(p, b, S + NEW))(
        jp, {"tokens": jnp.asarray(_prompt(jm.cfg.vocab_size, B, S))})
    decode = jax.jit(jm.decode_step)
    toks, outs = [], []
    for i in range(NEW):
        outs.append(np.asarray(logits[:, -1], np.float32))
        tok = jnp.argmax(logits[:, -1], axis=-1).astype(jnp.int32)[:, None]
        toks.append(np.asarray(tok))
        if i + 1 < NEW:
            logits, cache = decode(jp, cache, tok, jnp.int32(S + i))
    return np.concatenate(toks, axis=1), outs


def _port_greedy(m, p, B, S, opts):
    logits, cache = m.prefill(p, {"tokens": torch.as_tensor(_prompt(m.cfg.vocab_size, B, S))},
                              S + NEW, opts)
    toks, outs = [], []
    for i in range(NEW):
        outs.append(_np(logits[:, -1]))
        tok = logits[:, -1].argmax(-1).to(torch.int32)[:, None]
        toks.append(tok.numpy())
        if i + 1 < NEW:
            logits, cache = m.decode_step(p, cache, tok, S + i, opts)
    return np.concatenate(toks, axis=1), outs


@pytest.mark.parametrize("attn_impl", ["masked", "flash"])
def test_prefill_decode_matches_jax(attn_impl):
    """B=2, a 20-token prompt, 6 tokens: logits at every step, the streams."""
    jt, jl = _jax_greedy(2, 20)
    _, _, m, p = _models()
    tt, tl = _port_greedy(m, p, 2, 20, RunOpts(attn_impl=attn_impl, q_chunk=8, kv_chunk=8))
    for i, (a, b) in enumerate(zip(tl, jl)):
        np.testing.assert_allclose(a, b, **TOL, err_msg=f"step {i}")
    assert np.array_equal(tt, jt)


def test_decode_step_paged_matches_jax():
    """Two lanes prefilled (17 and 30 tokens) into scattered pool pages,
    then 5 paged decode steps in both packages."""
    jm, jp, m, p = _models()
    lens, P, ps = (17, 30), 9, 16
    pages = ([6, 1], [3, 7, 0])
    table = np.full((2, 3), -1, np.int32)
    pool = {k: np.zeros((m.cfg.num_layers, P, ps, m.cfg.num_kv_heads, HD), np.float32)
            for k in ("k_pages", "v_pages")}
    cur = []
    for b, n in enumerate(lens):
        jl, dense = jm.prefill(jp, {"tokens": jnp.asarray(_prompt(m.cfg.vocab_size, 1, n,
                                                                  seed=10 + b))}, n)
        for dk, pk in (("k", "k_pages"), ("v", "v_pages")):
            src = np.asarray(dense["blocks"][dk])[:, 0]
            L, T = src.shape[:2]
            pool[pk][:, pages[b][:T // ps]] = src.reshape(L, T // ps, ps, *src.shape[2:])
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


def test_engine_streams_equal_jax_oracle():
    """The port's ``DecodeEngine`` (2 lanes, 7 pages: page pressure) against
    the JAX package's prefill and paged decode under the same schedule."""
    jm, jp, m, p = _models()
    rng = np.random.RandomState(0)
    reqs = [Request(rid=i, prompt=rng.randint(0, m.cfg.vocab_size, n).astype(np.int32),
                    max_new_tokens=ENGINE_NEW) for i, n in enumerate((5, 17, 9, 30))]
    eng = DecodeEngine(m, ShardingLayout(attn_impl="flash"), "cpu", lanes=2, num_pages=7,
                       max_context=48)
    for r in reqs:
        eng.submit(r)
    done = {c.rid: c.tokens for c in eng.run(p)}
    assert done == _jax_engine_oracle(jm, jp, reqs, lanes=2, num_pages=7, max_context=48)


# ---------------------------------------------------------------------------
# training: 3 steps against build_train_step(..., constrain=None)
# ---------------------------------------------------------------------------

def test_train_step_matches_jax():
    """Loss and grad norm at every step, then params and AdamW first moments
    (the tied embedding's gets both the lookup's and the LM head's gradient)."""
    jcfg, cfg = _cfgs()
    jstate0 = jax.tree_util.tree_map(
        np.asarray, jax_steps.init_train_state(jax_build_model(jcfg), jax.random.key(0)))
    jtc = JaxTrainConfig(total_steps=10, warmup_steps=2, microbatches=2)
    jstep = jax.jit(jax_steps.build_train_step(
        jax_build_model(jcfg), jtc, JaxLayout(q_chunk=16, kv_chunk=16), constrain=None))
    tc = TrainConfig(total_steps=10, warmup_steps=2, microbatches=2)
    step = steps.build_train_step(build_model(cfg), tc,
                                  ShardingLayout(attn_impl="flash", q_chunk=16, kv_chunk=16))
    jds, ds = JaxSyntheticLM(256, 48, 4, seed=0), SyntheticLM(256, 48, 4, seed=0)
    jstate = jax.tree_util.tree_map(jnp.asarray, jstate0)
    state = train_state_from_jax(jstate0, cfg, "cpu")
    for i in range(3):
        jstate, jm = jstep(jstate, {k: jnp.asarray(v) for k, v in jds.batch(i).items()})
        state, m = step(state, {k: torch.from_numpy(v) for k, v in ds.batch(i).items()})
        for k in ("loss", "grad_norm"):
            np.testing.assert_allclose(float(m[k]), float(jm[k]), rtol=1e-4, err_msg=f"{k} {i}")
    ours, ref = train_state_to_numpy(state), jax.tree_util.tree_map(np.asarray, jstate)
    assert "lm_head" not in ours.params
    for tree, want in ((ours.params, ref.params), (ours.opt.m, ref.opt.m)):
        for a, b in zip(jax.tree_util.tree_leaves(tree), jax.tree_util.tree_leaves(want)):
            np.testing.assert_allclose(a, b, atol=1e-5, rtol=0)
    assert float(np.abs(ours.opt.m["embed"]).max()) > 0


def test_tied_embedding_gradient_matches_jax_grad():
    """The fused chunked CE over ``embed.T``: the embedding's gradient (the
    lookup's plus the LM head's) against ``jax.grad`` of the reference's
    loss, atol 1e-5."""
    jm, jp, m, p = _models()
    toks, labels = _prompt(256, 2, 32, seed=3), _prompt(256, 2, 32, seed=4)

    def jloss(params):
        x, _ = jm.forward_hidden(params, {"tokens": jnp.asarray(toks)})
        return jax_steps.chunked_cross_entropy(x, jm.unembed_weight(params),
                                               jnp.asarray(labels), 16)

    want = np.asarray(jax.grad(jloss)(jp)["embed"])
    embed = p["embed"].clone().requires_grad_()
    x, _ = m.forward_hidden(dict(p, embed=embed), {"tokens": torch.from_numpy(toks)})
    steps.chunked_cross_entropy(x, m.unembed_weight(dict(p, embed=embed)),
                                torch.from_numpy(labels), 16).backward()
    np.testing.assert_allclose(embed.grad.numpy(), want, atol=1e-5, rtol=0)


# ---------------------------------------------------------------------------
# bf16: the f32 residual stream
# ---------------------------------------------------------------------------

def _norm_input_dtypes(fn):
    """Run ``fn``; return the dtypes of every RMSNorm input (gemma has no
    qk-norm, so each is the residual stream: ln1, ln2, final_norm)."""
    seen = []
    norm = layers.rmsnorm

    def recording(params, x, eps):
        seen.append(x.dtype)
        return norm(params, x, eps)

    with mock.patch.object(layers, "rmsnorm", recording):
        fn()
    return seen


def _bf16_entry_points(m, p, tokens):
    """(prefill logits, the norm input dtypes by entry point: the training
    forward, prefill, decode_step, decode_step_paged)."""
    L = m.cfg.num_layers
    out = {}
    prefill = lambda: out.setdefault("prefill", m.prefill(p, {"tokens": tokens}, 24))
    dtypes = {"forward": _norm_input_dtypes(lambda: m.forward(p, {"tokens": tokens})),
              "prefill": _norm_input_dtypes(prefill)}
    logits, cache = out["prefill"]
    tok = logits[:, -1].argmax(-1).to(torch.int32)[:, None]
    dtypes["decode_step"] = _norm_input_dtypes(lambda: m.decode_step(p, cache, tok, 20))
    pool = transformer.init_paged_cache(m.cfg, 9, "cpu")
    table = torch.tensor([[0, 1], [2, 3]], dtype=torch.int32)
    lens = torch.tensor([3, 5], dtype=torch.int32)
    dtypes["decode_step_paged"] = _norm_input_dtypes(
        lambda: m.decode_step_paged(p, pool, tok, lens, table))
    assert all(len(d) == 2 * L + 1 for d in dtypes.values())
    return logits, dtypes


def _jax_bf16_logits(tokens):
    jm, jp, _, _ = _models("bfloat16")
    logits, _ = jm.prefill(jp, {"tokens": jnp.asarray(tokens)}, 24)
    return np.asarray(logits[:, -1], np.float32)


def test_bf16_residual_is_f32_and_logits_match_jax():
    _, _, m, p = _models("bfloat16")
    tokens = _prompt(m.cfg.vocab_size, 2, 20, seed=7)
    logits, dtypes = _bf16_entry_points(m, p, torch.from_numpy(tokens))
    assert logits.dtype == torch.bfloat16
    for where, d in dtypes.items():
        assert set(d) == {torch.float32}, where
    want = _jax_bf16_logits(tokens)
    got = _np(logits[:, -1])
    # tied logits are rows of the embedding (std 1) dotted with the normed
    # hidden state: their std is ~14, so the repository's bf16 tolerance is
    # applied in units of it (XLA and torch round bf16 at other places)
    scale = float(want.std())
    np.testing.assert_allclose(got / scale, want / scale, **BF16_TOL)
    assert np.array_equal(got.argmax(-1), want.argmax(-1))


def test_python_float_scale_mutant_fails():
    """Scaling by a Python float keeps the residual in bf16: the dtype hold
    above catches it at every entry point, and its prefill logits are on
    average more than twice as far from the reference's as the port's
    (their largest error is within the scaled tolerance above, which holds
    rounding, not the residual's dtype)."""
    def bf16_scale(params, tokens, cfg):
        x = params["embed"][tokens.long()].to(torch.bfloat16)
        return x * float(np.sqrt(cfg.d_model))

    _, _, m, p = _models("bfloat16")
    tokens = _prompt(m.cfg.vocab_size, 2, 20, seed=7)
    want = _jax_bf16_logits(tokens)
    good, _ = _bf16_entry_points(m, p, torch.from_numpy(tokens))
    with mock.patch.object(transformer, "_embed_tokens", bf16_scale):
        bad, dtypes = _bf16_entry_points(m, p, torch.from_numpy(tokens))
    for where, d in dtypes.items():
        assert torch.bfloat16 in d, where
    err = lambda t: float(np.abs(_np(t[:, -1]) - want).mean())
    assert err(bad) > 2 * err(good)
