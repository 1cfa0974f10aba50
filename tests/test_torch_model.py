"""The PyTorch port's dense decoder against the JAX package's, on the CPU.

``qwen3-4b`` reduced, at f32 (``dtype="float32"``) and at bf16, with the
JAX params from ``Model.init(jax.random.key(0))`` carried across by
``params_from_jax``. Inputs are made with numpy from a seed. Tolerances:
f32 atol=rtol=1e-4 (XLA and torch sum matmuls in different orders); bf16
the repository's 2e-2, plus top-1 agreement.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.config import get_arch as jax_get_arch
from repro.models import build_model as jax_build_model
from repro.models.transformer import RunOpts as JaxRunOpts
from repro_torch.config import get_arch
from repro_torch.models import RunOpts, build_model
from repro_torch.models.convert import params_from_jax, params_to_numpy

F32, BF16 = "float32", "bfloat16"


def tol(dtype):
    return dict(atol=2e-2, rtol=2e-2) if dtype == BF16 else dict(atol=1e-4, rtol=1e-4)


@pytest.fixture(scope="module")
def jax_params():
    cfg = jax_get_arch("qwen3-4b").reduced()
    return jax.tree_util.tree_map(np.asarray, jax_build_model(cfg).init(jax.random.key(0)))


def _pair(dtype, jax_params):
    """(JAX model, JAX params, port model, port params) at ``dtype``."""
    jcfg = dataclasses.replace(jax_get_arch("qwen3-4b").reduced(), dtype=dtype)
    cfg = dataclasses.replace(get_arch("qwen3-4b").reduced(), dtype=dtype)
    jp = jax.tree_util.tree_map(jnp.asarray, jax_params)
    tdtype = torch.bfloat16 if dtype == BF16 else None
    return (jax_build_model(jcfg), jp, build_model(cfg),
            params_from_jax(jax_params, cfg, "cpu", dtype=tdtype))


def _plain(cfg) -> dict:
    return {k: getattr(v, "value", v) for k, v in dataclasses.asdict(cfg).items()}


def test_config_copy_matches_reference():
    for pick in (lambda c: c, lambda c: c.reduced()):
        assert _plain(pick(get_arch("qwen3-4b"))) == _plain(pick(jax_get_arch("qwen3-4b")))


def _np(x):
    return x.float().numpy() if isinstance(x, torch.Tensor) else np.asarray(x, np.float32)


def test_params_round_trip_bit_exact(jax_params):
    cfg = get_arch("qwen3-4b").reduced()
    back = params_to_numpy(params_from_jax(jax_params, cfg, "cpu"))
    flat_a = jax.tree_util.tree_leaves_with_path(jax_params)
    flat_b = dict(jax.tree_util.tree_leaves_with_path(back))
    assert len(flat_a) == len(flat_b)
    for path, a in flat_a:
        assert np.array_equal(a, flat_b[path]) and flat_b[path].dtype == a.dtype, path


def test_bf16_storage_casts_matrices_only(jax_params):
    cfg = get_arch("qwen3-4b").reduced()
    p = params_from_jax(jax_params, cfg, "cpu", dtype=torch.bfloat16)
    assert p["embed"].dtype == p["blocks"]["attn"]["wq"].dtype == torch.bfloat16
    assert p["lm_head"].dtype == p["blocks"]["mlp"]["wo"].dtype == torch.bfloat16
    for norm in (p["final_norm"]["scale"], p["blocks"]["ln1"]["scale"],
                 p["blocks"]["attn"]["q_norm"], p["blocks"]["attn"]["k_norm"]):
        assert norm.dtype == torch.float32


@pytest.mark.parametrize("dtype", [F32, BF16])
@pytest.mark.parametrize("attn_impl", ["masked", "flash"])
@pytest.mark.parametrize("S", [16, 23])
def test_prefill_matches_jax(jax_params, dtype, attn_impl, S):
    jm, jp, m, p = _pair(dtype, jax_params)
    toks = np.random.RandomState(S).randint(0, m.cfg.vocab_size, (1, S)).astype(np.int32)
    jl, jc = jm.prefill(jp, {"tokens": jnp.asarray(toks)}, S, JaxRunOpts(attn_impl=attn_impl))
    tl, tc = m.prefill(p, {"tokens": torch.as_tensor(toks)}, S, RunOpts(attn_impl=attn_impl))
    np.testing.assert_allclose(_np(tl), _np(jl), **tol(dtype))
    assert int(tl[0, -1].argmax()) == int(jnp.argmax(jl[0, -1]))
    assert set(tc["blocks"]) == set(jc["blocks"]) == {"k", "v", "pos_ids"}
    for key in ("k", "v"):
        assert tuple(tc["blocks"][key].shape) == jc["blocks"][key].shape
        np.testing.assert_allclose(_np(tc["blocks"][key]), _np(jc["blocks"][key]), **tol(dtype))
    assert np.array_equal(tc["blocks"]["pos_ids"].numpy(), np.asarray(jc["blocks"]["pos_ids"]))


def _paged_state(cfg, dtype, seed=0):
    """A pool with random contents, three lanes: lane 0 and 2 live with
    non-contiguous pages, lane 1 dead (seq_len 0, no pages)."""
    rng = np.random.RandomState(seed)
    L, KVH, hd, ps = cfg.num_layers, cfg.num_kv_heads, cfg.resolved_head_dim, 16
    P = 12
    pools = {k: rng.randn(L, P, ps, KVH, hd).astype(np.float32) for k in ("k_pages", "v_pages")}
    table = np.full((3, 4), -1, np.int32)
    table[0, :2] = [7, 2]           # 20 cached: pages 7 then 2
    table[2, :3] = [3, 10, 5]       # 33 cached: three scattered pages
    seq_lens = np.asarray([20, 0, 33], np.int32)
    tokens = rng.randint(0, cfg.vocab_size, (3, 1)).astype(np.int32)
    jd = jnp.dtype(dtype)
    jcache = {"blocks": {k: jnp.asarray(v, jd) for k, v in pools.items()}}
    tcache = {"blocks": {k: torch.from_numpy(v).to(getattr(torch, dtype))
                         for k, v in pools.items()}}
    return jcache, tcache, tokens, seq_lens, table


@pytest.mark.parametrize("dtype", [F32, BF16])
@pytest.mark.parametrize("use_kernel", [False, True])
def test_decode_step_paged_matches_jax(jax_params, dtype, use_kernel):
    """The port's one decode path against both JAX paths: its jnp gather
    and its Pallas kernel in interpret mode."""
    jm, jp, m, p = _pair(dtype, jax_params)
    jcache, tcache, tokens, seq_lens, table = _paged_state(m.cfg, dtype)
    jl, jc = jm.decode_step_paged(
        jp, jcache, jnp.asarray(tokens), jnp.asarray(seq_lens), jnp.asarray(table),
        use_kernel=use_kernel, interpret=use_kernel,
    )
    tl, tc = m.decode_step_paged(
        p, tcache, torch.as_tensor(tokens), torch.as_tensor(seq_lens), torch.as_tensor(table),
    )
    np.testing.assert_allclose(_np(tl), _np(jl), **tol(dtype))
    assert np.array_equal(tl[:, -1].argmax(-1).numpy(), np.asarray(jnp.argmax(jl[:, -1], -1)))
    for key in ("k_pages", "v_pages"):
        np.testing.assert_allclose(_np(tc["blocks"][key]), _np(jc["blocks"][key]), **tol(dtype))


def _greedy(prefill, decode, argmax, prompt, n_new, table, feed=None):
    """Prefill then ``n_new - 1`` single-lane paged decode steps; ``feed``
    (teacher forcing) replaces each sampled token when given."""
    logits = prefill(prompt)
    out, tops = [], []
    for i in range(n_new):
        top = argmax(logits)
        tops.append(top)
        tok = top if feed is None else feed[i]
        out.append(tok)
        if i + 1 < n_new:
            logits = decode(tok, len(prompt) + i, table)
    return out, tops


def _run_stream(jm, jp, m, p, dtype, prompt, n_new, feed=None):
    """Greedy stream of both stacks: dense prefill, pack into pages
    [5, 1, 3] of an 8-page pool, then paged decode steps."""
    ps, pages = 16, [5, 1, 3]
    S = len(prompt)
    table = np.full((1, 4), -1, np.int32)
    table[0, :3] = pages
    n_dense = -(-S // ps)
    state = {}

    def j_prefill(tokens):
        logits, dense = jm.prefill(jp, {"tokens": jnp.asarray(tokens[None])}, S)
        cache = jm.init_paged_cache(8)
        for dk, pk in (("k", "k_pages"), ("v", "v_pages")):
            src = dense["blocks"][dk][:, 0]
            L, T = src.shape[:2]
            cache["blocks"][pk] = cache["blocks"][pk].at[:, jnp.asarray(pages[:n_dense])].set(
                src.reshape(L, T // ps, ps, *src.shape[2:]))
        state["j"] = cache
        return logits

    def j_decode(tok, pos, tbl):
        logits, state["j"] = jm.decode_step_paged(
            jp, state["j"], jnp.asarray([[tok]], jnp.int32), jnp.asarray([pos], jnp.int32),
            jnp.asarray(tbl))
        return logits

    def t_prefill(tokens):
        logits, dense = m.prefill(p, {"tokens": torch.as_tensor(tokens[None])}, S)
        cache = m.init_paged_cache(8, "cpu")
        for dk, pk in (("k", "k_pages"), ("v", "v_pages")):
            src = dense["blocks"][dk][:, 0]
            L, T = src.shape[:2]
            cache["blocks"][pk][:, torch.as_tensor(pages[:n_dense])] = src.reshape(
                L, T // ps, ps, *src.shape[2:])
        state["t"] = cache
        return logits

    def t_decode(tok, pos, tbl):
        logits, state["t"] = m.decode_step_paged(
            p, state["t"], torch.as_tensor([[tok]]), torch.as_tensor([pos], dtype=torch.int32),
            torch.as_tensor(tbl))
        return logits

    jres = _greedy(j_prefill, j_decode, lambda lg: int(jnp.argmax(lg[0, -1])),
                   prompt, n_new, table, feed)
    tres = _greedy(t_prefill, t_decode, lambda lg: int(lg[0, -1].argmax()),
                   prompt, n_new, table, feed)
    return jres, tres


def test_greedy_stream_identical_f32(jax_params):
    jm, jp, m, p = _pair(F32, jax_params)
    prompt = np.random.RandomState(7).randint(0, m.cfg.vocab_size, 21).astype(np.int32)
    (j_stream, _), (t_stream, _) = _run_stream(jm, jp, m, p, F32, prompt, 16)
    assert t_stream == j_stream


def test_greedy_top1_agrees_bf16(jax_params):
    """bf16: both stacks fed the JAX stream (teacher forcing) agree on the
    top-1 token at every one of the 16 steps."""
    jm, jp, m, p = _pair(BF16, jax_params)
    prompt = np.random.RandomState(7).randint(0, m.cfg.vocab_size, 21).astype(np.int32)
    (j_stream, _), _ = _run_stream(jm, jp, m, p, BF16, prompt, 16)
    (_, j_tops), (_, t_tops) = _run_stream(jm, jp, m, p, BF16, prompt, 16, feed=j_stream)
    assert t_tops == j_tops


def test_entry_points_refuse_missing_cuda(monkeypatch):
    """Asked for the default device (cuda) with no GPU present, the port
    raises instead of running on the CPU."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    m = build_model(get_arch("qwen3-4b").reduced())
    with pytest.raises(RuntimeError, match="CUDA"):
        m.init(torch.Generator())
    with pytest.raises(RuntimeError, match="CUDA"):
        m.init_paged_cache(4)
