"""The port's MoE family (``models/moe.py``, the MOE block of
``models/transformer.py``) against the JAX package's, on the CPU.

Weights come from the reference's ``init`` (``jax.random.key(0)``) through
``params_from_jax``; inputs are made with numpy from a seed. Tolerances,
at f32: the block's output atol 1e-5, its aux loss rtol 1e-6 and its
expert counters ``==``; prefill + greedy decode logits atol=rtol=1e-4 at
every step with identical streams and each layer's ``moe_load`` ``==``;
training loss, ``aux_loss`` and grad norm rtol 1e-4 and params atol 1e-5
(XLA and torch sum in different orders). The cases of
``tests/test_moe_decode_load.py`` run on the port with the reference's
``tiny_moe`` construction (bf16, top-1, every token to expert 0)."""
import dataclasses
import functools

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
from repro.models import moe as jax_moe
from repro.models import transformer as jax_transformer
from repro.models.common import init_params as jax_init_params
from repro.train import steps as jax_steps
from repro_torch.config import ShardingLayout, TrainConfig, get_arch
from repro_torch.data import SyntheticLM
from repro_torch.launch import serve as serve_launcher
from repro_torch.models import RunOpts, build_model, moe, transformer
from repro_torch.models.convert import (
    cache_from_jax,
    cache_to_numpy,
    params_from_jax,
    train_state_from_jax,
    train_state_to_numpy,
)
from repro_torch.train import steps

MIXTRAL, PHI = "mixtral-8x7b", "phi3.5-moe-42b-a6.6b"
F32, BF16 = "float32", "bfloat16"
NEW = 16


def _spec_fields(tree):
    if isinstance(tree, dict):
        return {k: _spec_fields(v) for k, v in tree.items()}
    return (tuple(tree.shape), tuple(tree.axes), tree.init, tree.scale, tree.dtype)


def _cfgs(arch, dtype=F32, **moe_kw):
    jcfg, cfg = jax_get_arch(arch).reduced(), get_arch(arch).reduced()
    pick = lambda c: dataclasses.replace(c, dtype=dtype, moe=dataclasses.replace(c.moe, **moe_kw))
    return pick(jcfg), pick(cfg)


def _block_params(jcfg, cfg):
    jp = jax_init_params(jax_moe.moe_spec(jcfg), jax.random.key(0))
    return jp, {k: torch.from_numpy(np.array(v, np.float32)) for k, v in jp.items()}


# ---------------------------------------------------------------------------
# specs and dtypes
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("arch", [MIXTRAL, PHI])
@pytest.mark.parametrize("reduced", [False, True])
def test_specs_match_jax(arch, reduced):
    pick = (lambda c: c.reduced()) if reduced else (lambda c: c)
    cfg, jcfg = pick(get_arch(arch)), pick(jax_get_arch(arch))
    assert dataclasses.asdict(cfg) == dataclasses.asdict(jcfg)
    assert _spec_fields(build_model(cfg).specs) == _spec_fields(jax_build_model(jcfg).specs)
    assert build_model(cfg).param_count() == jax_build_model(jcfg).param_count()
    for batch, seq in ((2, 36), (4, 8192 + 32)):
        assert (_spec_fields(transformer.cache_specs(cfg, batch, seq))
                == _spec_fields(jax_transformer.cache_specs(jcfg, batch, seq)))


def test_full_width_shapes():
    mix, phi = get_arch(MIXTRAL), get_arch(PHI)
    assert (mix.d_model, mix.num_heads, mix.num_kv_heads, mix.d_ff, mix.window,
            mix.moe.num_experts, mix.moe.top_k) == (4096, 32, 8, 14336, 4096, 8, 2)
    assert (phi.d_ff, phi.window, phi.moe.num_experts) == (6400, 0, 16)
    assert transformer.cache_len_for(mix, 8192 + 32) == 4096
    cut = lambda c: build_model(dataclasses.replace(c, num_layers=16)).param_count() / 1e9
    assert abs(cut(mix) - 23.48) < 5e-3 and abs(cut(phi) - 21.07) < 5e-3


def test_large_leaves_are_drawn_by_slice(monkeypatch):
    """A leaf above ``DRAW_BY_SLICE_NUMEL`` is drawn one leading slice at a
    time (its f32 draw never sits beside the whole leaf), at the spec's
    std, in the storage dtype; a leaf at or below it is drawn at once, as
    before (the same numbers as one ``randn`` of its shape)."""
    from repro_torch.models import common

    spec = common.ParamSpec((3, 4, 64, 16), ("layers", "experts", "embed", "ffn"))
    whole = common._init_one(spec, torch.Generator().manual_seed(0), "cpu", None)
    want = torch.randn(spec.shape, generator=torch.Generator().manual_seed(0)) / 8.0
    assert torch.equal(whole, want)
    monkeypatch.setattr(common, "DRAW_BY_SLICE_NUMEL", 4 * 64 * 16)
    sliced = common._init_one(spec, torch.Generator().manual_seed(0), "cpu", torch.bfloat16)
    assert sliced.dtype == torch.bfloat16 and tuple(sliced.shape) == spec.shape
    assert abs(float(sliced.float().std()) - 1 / 8) < 0.01
    gen = torch.Generator().manual_seed(0)
    first = (torch.randn(spec.shape[1:], generator=gen) / 8.0).to(torch.bfloat16)
    assert torch.equal(sliced[0], first)


def _dtypes(tree, prefix=""):
    if isinstance(tree, dict):
        return {k: v for key, sub in tree.items()
                for k, v in _dtypes(sub, f"{prefix}{key}.").items()}
    return {prefix[:-1]: tree.dtype}


@functools.lru_cache(maxsize=None)
def _jax_params(arch):
    cfg = jax_get_arch(arch).reduced()
    return jax.tree_util.tree_map(np.asarray, jax_build_model(cfg).init(jax.random.key(0)))


@pytest.mark.parametrize("arch", [MIXTRAL, PHI])
def test_served_router_stays_f32(arch):
    """Stored for bf16 serving (by ``Model.init`` and by
    ``params_from_jax``), the router keeps f32 like the norm scales; every
    other matrix is bf16."""
    cfg = get_arch(arch).reduced()
    made = build_model(cfg).init(torch.Generator().manual_seed(0), "cpu", torch.bfloat16)
    carried = params_from_jax(_jax_params(arch), cfg, "cpu", dtype=torch.bfloat16)
    for params in (made, carried):
        dt = _dtypes(params)
        f32 = {k for k, v in dt.items() if v == torch.float32}
        assert f32 == {"final_norm.scale", "blocks.ln1.scale", "blocks.ln2.scale",
                       "blocks.moe.router"}
        assert all(v == torch.bfloat16 for k, v in dt.items() if k not in f32)
    np.testing.assert_array_equal(carried["blocks"]["moe"]["router"].numpy(),
                                  _jax_params(arch)["blocks"]["moe"]["router"])


# ---------------------------------------------------------------------------
# moe_block and moe_decode_block against the reference
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("arch", [MIXTRAL, PHI])
@pytest.mark.parametrize("S", [1, 7, 32])
@pytest.mark.parametrize("cf", [1.25, 0.5], ids=["cf1.25", "cf0.5-drops"])
def test_moe_block_matches_jax(arch, S, cf):
    jcfg, cfg = _cfgs(arch, capacity_factor=cf)
    jp, tp = _block_params(jcfg, cfg)
    x = np.random.RandomState(S).randn(3, S, cfg.d_model).astype(np.float32)
    jo, ja, jl = jax.jit(lambda p, v: jax_moe.moe_block(p, v, jcfg))(jp, jnp.asarray(x))
    to, ta, tl = moe.moe_block(tp, torch.from_numpy(x), cfg)
    np.testing.assert_allclose(to.numpy(), np.asarray(jo), atol=1e-5, rtol=0)
    np.testing.assert_allclose(float(ta), float(ja), rtol=1e-6)
    assert tl.dtype == torch.int32 and np.array_equal(tl.numpy(), np.asarray(jl))
    if cf < 1 and S > 1:
        # a capacity below the mean load drops assignments
        cap = moe._capacity(cfg, S)
        assert int(tl.max()) > cap


@pytest.mark.parametrize("packing", ["sequence", "global"])
@pytest.mark.parametrize("pos", [0, 5, 40])
def test_moe_decode_block_matches_jax(packing, pos):
    jcfg, cfg = _cfgs(MIXTRAL)
    jp, tp = _block_params(jcfg, cfg)
    rng = np.random.RandomState(pos)
    B, E = 6, cfg.moe.num_experts
    x = rng.randn(B, 1, cfg.d_model).astype(np.float32)
    load = rng.randint(0, pos + 2, (B, E)).astype(np.int32)
    jo, jl = jax.jit(lambda p, v, l, q: jax_moe.moe_decode_block(p, v, l, q, jcfg,
                                                                 packing=packing))(
        jp, jnp.asarray(x), jnp.asarray(load), jnp.int32(pos))
    to, tl = moe.moe_decode_block(tp, torch.from_numpy(x), torch.from_numpy(load), pos, cfg,
                                  packing=packing)
    np.testing.assert_allclose(to.numpy(), np.asarray(jo), atol=1e-5, rtol=0)
    assert tl.dtype == torch.int32 and np.array_equal(tl.numpy(), np.asarray(jl))


# ---------------------------------------------------------------------------
# tests/test_moe_decode_load.py on the port
# ---------------------------------------------------------------------------

@pytest.fixture(scope="module")
def tiny_moe():
    """The reference's fixture: mixtral's MoE block forced to top-1 routing,
    capacity factor 1, with a zero router but column 0 set, so that every
    non-negative input routes to expert 0 (and the other experts tie)."""
    cfg = get_arch(MIXTRAL).reduced()
    cfg = dataclasses.replace(cfg, moe=dataclasses.replace(cfg.moe, top_k=1,
                                                           capacity_factor=1.0))
    jcfg = jax_get_arch(MIXTRAL).reduced()
    jcfg = dataclasses.replace(jcfg, moe=dataclasses.replace(jcfg.moe, top_k=1,
                                                             capacity_factor=1.0))
    params = jax_init_params(jax_moe.moe_spec(jcfg), jax.random.key(0))
    router = jnp.zeros((cfg.d_model, cfg.moe.num_experts), jnp.float32)
    params = dict(params, router=router.at[:, 0].set(1.0))
    return cfg, {k: torch.from_numpy(np.array(v, np.float32)) for k, v in params.items()}


def _x(key, B, d):
    x = jax.random.normal(jax.random.key(key), (B, 1, d), jnp.bfloat16)
    return torch.from_numpy(np.asarray(jnp.abs(x), np.float32)).to(torch.bfloat16)


def _decode(cfg, params, x, load, pos, packing="sequence"):
    out, new_load = moe.moe_decode_block(params, x, torch.as_tensor(load, dtype=torch.int32),
                                         pos, cfg, packing=packing)
    return out.float().numpy(), new_load.numpy()


@pytest.mark.parametrize("packing", ["sequence", "global"])
def test_counters_count_kept_and_dropped(tiny_moe, packing):
    cfg, params = tiny_moe
    E, B = cfg.moe.num_experts, 4
    x = torch.ones((B, 1, cfg.d_model), dtype=torch.bfloat16)
    _, new_load = _decode(cfg, params, x, np.zeros((B, E)), 8, packing)
    np.testing.assert_array_equal(new_load[:, 0], np.ones(B))
    np.testing.assert_array_equal(new_load[:, 1:], np.zeros((B, E - 1)))


def test_contended_batch_serves_every_sequence(tiny_moe):
    cfg, params = tiny_moe
    E, B = cfg.moe.num_experts, 4
    x = _x(1, B, cfg.d_model)
    batched, _ = _decode(cfg, params, x, np.zeros((B, E)), 8)
    singles = np.concatenate([_decode(cfg, params, x[b:b + 1], np.zeros((1, E)), 8)[0]
                              for b in range(B)])
    assert np.abs(singles).max(axis=(1, 2)).min() > 0
    np.testing.assert_array_equal(batched, singles)


def test_global_packing_overflow_drop_pinned(tiny_moe):
    cfg, params = tiny_moe
    E, B = cfg.moe.num_experts, 4
    x = _x(1, B, cfg.d_model)
    batched, _ = _decode(cfg, params, x, np.zeros((B, E)), 8, "global")
    singles = np.concatenate([_decode(cfg, params, x[b:b + 1], np.zeros((1, E)), 8, "global")[0]
                              for b in range(B)])
    assert np.abs(singles).max(axis=(1, 2)).min() > 0
    np.testing.assert_array_equal(batched[0], singles[0])
    np.testing.assert_array_equal(batched[1:], np.zeros_like(batched[1:]))


@pytest.mark.parametrize("packing", ["sequence", "global"])
def test_mixed_length_contended_batch(tiny_moe, packing):
    """Sequence 0 reached the forward's capacity (counter-dropped either
    way). Default packing serves every short sequence as its solo decode;
    the global pack serves the first short one and drops the rest."""
    cfg, params = tiny_moe
    E, B = cfg.moe.num_experts, 4
    x = _x(2, B, cfg.d_model)
    load = np.zeros((B, E))
    load[0, 0] = 2
    batched, new_load = _decode(cfg, params, x, load, 8, packing)
    singles = [_decode(cfg, params, x[b:b + 1], load[b:b + 1], 8, packing)[0] for b in range(B)]
    np.testing.assert_array_equal(batched[0], np.zeros_like(batched[0]))
    served = (1, 2, 3) if packing == "sequence" else (1,)
    for b in range(1, B):
        assert np.abs(singles[b]).max() > 0
        want = singles[b][0] if b in served else np.zeros_like(batched[b])
        np.testing.assert_array_equal(batched[b], want)
    if packing == "sequence":
        np.testing.assert_array_equal(singles[0][0], np.zeros_like(singles[0][0]))
    np.testing.assert_array_equal(new_load[:, 0], load[:, 0] + 1)


def test_tiny_moe_matches_jax_decode(tiny_moe):
    """The fixture's bf16 decode on the port against the reference's (both
    packings, the mixed-length batch): the same rows served and dropped,
    the same counters, the served rows within the repository's bf16
    tolerance (2e-2: the two stacks' bf16 products accumulate in other
    orders)."""
    cfg, params = tiny_moe
    jcfg = jax_get_arch(MIXTRAL).reduced()
    jcfg = dataclasses.replace(jcfg, moe=dataclasses.replace(jcfg.moe, top_k=1,
                                                             capacity_factor=1.0))
    jp = {k: jnp.asarray(v.numpy()) for k, v in params.items()}
    x = _x(2, 4, cfg.d_model)
    load = np.zeros((4, cfg.moe.num_experts), np.int32)
    load[0, 0] = 2
    for packing in ("sequence", "global"):
        jo, jl = jax_moe.moe_decode_block(jp, jnp.asarray(x.float().numpy(), jnp.bfloat16),
                                          jnp.asarray(load), jnp.int32(8), jcfg,
                                          packing=packing)
        to, tl = _decode(cfg, params, x, load, 8, packing)
        jo = np.asarray(jo, np.float32)
        np.testing.assert_array_equal(np.abs(to).max(axis=(1, 2)) > 0,
                                      np.abs(jo).max(axis=(1, 2)) > 0)
        np.testing.assert_allclose(to, jo, atol=2e-2, rtol=2e-2)
        np.testing.assert_array_equal(tl, np.asarray(jl))


# ---------------------------------------------------------------------------
# reduced models: prefill + greedy decode against the JAX Model
# ---------------------------------------------------------------------------

def _prompt(vocab, B, S, seed=0):
    return np.random.RandomState(seed).randint(0, vocab, (B, S)).astype(np.int32)


@functools.lru_cache(maxsize=None)
def _jax_greedy(arch, B, S):
    cfg = dataclasses.replace(jax_get_arch(arch).reduced(), dtype=F32)
    model = jax_build_model(cfg)
    params = jax.tree_util.tree_map(jnp.asarray, _jax_params(arch))
    prefill = jax.jit(lambda p, b: model.prefill(p, b, S + NEW))
    decode = jax.jit(model.decode_step)
    logits, cache = prefill(params, {"tokens": jnp.asarray(_prompt(cfg.vocab_size, B, S))})
    toks, outs, loads = [], [], []
    for i in range(NEW):
        outs.append(np.asarray(logits[:, -1], np.float32))
        loads.append(np.asarray(cache["blocks"]["moe_load"]))
        tok = jnp.argmax(logits[:, -1], axis=-1).astype(jnp.int32)[:, None]
        toks.append(np.asarray(tok))
        if i + 1 < NEW:
            logits, cache = decode(params, cache, tok, jnp.int32(S + i))
    cache = jax.tree_util.tree_map(lambda a: np.asarray(a, np.float32)
                                   if a.dtype != jnp.int32 else np.asarray(a), cache)
    return np.concatenate(toks, axis=1), outs, loads, cache


def _port_greedy(arch, B, S, opts=RunOpts()):
    cfg = dataclasses.replace(get_arch(arch).reduced(), dtype=F32)
    model = build_model(cfg)
    params = params_from_jax(_jax_params(arch), cfg, "cpu")
    logits, cache = model.prefill(
        params, {"tokens": torch.as_tensor(_prompt(cfg.vocab_size, B, S))}, S + NEW, opts)
    toks, outs, loads = [], [], []
    for i in range(NEW):
        outs.append(logits[:, -1].float().numpy())
        loads.append(cache["blocks"]["moe_load"].clone().numpy())
        tok = logits[:, -1].argmax(-1).to(torch.int32)[:, None]
        toks.append(tok.numpy())
        if i + 1 < NEW:
            logits, cache = model.decode_step(params, cache, tok, S + i, opts)
    return np.concatenate(toks, axis=1), outs, loads, cache_to_numpy(cache)


@pytest.mark.parametrize("arch", [MIXTRAL, PHI])
@pytest.mark.parametrize("attn_impl", ["masked", "flash"])
def test_prefill_decode_f32_matches_jax(arch, attn_impl):
    """B=2, a 20-token prompt, 16 tokens: mixtral's window of 8 makes a
    16-slot ring that the prompt overfills and decode wraps."""
    jt, jl, jload, jc = _jax_greedy(arch, 2, 20)
    tt, tl, tload, tc = _port_greedy(arch, 2, 20, RunOpts(attn_impl=attn_impl))
    for i, (a, b) in enumerate(zip(tl, jl)):
        np.testing.assert_allclose(a, b, atol=1e-4, rtol=1e-4, err_msg=f"step {i}")
    assert np.array_equal(tt, jt)
    for i, (a, b) in enumerate(zip(tload, jload)):
        assert a.dtype == np.int32 and np.array_equal(a, b), f"moe_load before step {i}"
    assert set(tc["blocks"]) == {"k", "v", "pos_ids", "moe_load"}
    for key in ("k", "v"):
        np.testing.assert_allclose(tc["blocks"][key], jc["blocks"][key], atol=1e-4, rtol=1e-4)
    for key in ("pos_ids", "moe_load"):
        assert np.array_equal(tc["blocks"][key], jc["blocks"][key]), key


def test_cache_round_trip_from_jax():
    """A JAX MoE prefill cache (bf16 k/v, int32 pos_ids and moe_load) comes
    across exactly, and a decode step from it gives JAX's counters."""
    jcfg, cfg = jax_get_arch(MIXTRAL).reduced(), get_arch(MIXTRAL).reduced()
    jm, m = jax_build_model(jcfg), build_model(cfg)
    jp = jax.tree_util.tree_map(jnp.asarray, _jax_params(MIXTRAL))
    toks = _prompt(cfg.vocab_size, 2, 20)
    _, jcache = jax.jit(lambda p, b: jm.prefill(p, b, 20 + NEW))(jp, {"tokens": toks})
    tcache = cache_from_jax(jax.tree_util.tree_map(np.asarray, jcache), cfg, 2, 20 + NEW, "cpu")
    assert tcache["blocks"]["moe_load"].dtype == torch.int32
    back = cache_to_numpy(tcache)
    for key in ("pos_ids", "moe_load"):
        assert back["blocks"][key].dtype == np.int32
        assert np.array_equal(back["blocks"][key], np.asarray(jcache["blocks"][key])), key
    tok = np.asarray([[3], [7]], np.int32)
    _, jnew = jax.jit(jm.decode_step)(jp, jcache, jnp.asarray(tok), jnp.int32(20))
    tp = params_from_jax(_jax_params(MIXTRAL), cfg, "cpu", dtype=torch.bfloat16)
    _, tnew = m.decode_step(tp, tcache, torch.as_tensor(tok), 20)
    assert np.array_equal(tnew["blocks"]["moe_load"].numpy(),
                          np.asarray(jnew["blocks"]["moe_load"]))


def test_decode_updates_moe_load_in_place():
    """decode_step writes the counters into the cache it was given (one
    buffer for the cache's life), and a prefill's counters are its own
    tensors."""
    cfg = dataclasses.replace(get_arch(MIXTRAL).reduced(), dtype=F32)
    model = build_model(cfg)
    params = params_from_jax(_jax_params(MIXTRAL), cfg, "cpu")
    _, cache = model.prefill(params, {"tokens": torch.as_tensor(_prompt(256, 2, 5))}, 8)
    buf = cache["blocks"]["moe_load"]
    before = buf.clone()
    _, out = model.decode_step(params, cache, torch.zeros((2, 1), dtype=torch.int32), 5)
    assert out["blocks"]["moe_load"] is buf
    assert int((buf - before).sum()) == cfg.num_layers * 2 * cfg.moe.top_k


def test_greedy_serve_matches_jax_greedy_loop():
    jt, jl, _, _ = _jax_greedy(MIXTRAL, 2, 20)
    cfg = dataclasses.replace(get_arch(MIXTRAL).reduced(), dtype=F32)
    model = build_model(cfg)
    res = serve_launcher.greedy_serve(
        model, params_from_jax(_jax_params(MIXTRAL), cfg, "cpu"),
        torch.as_tensor(_prompt(cfg.vocab_size, 2, 20)), NEW, ShardingLayout(attn_impl="flash"))
    assert np.array_equal(res.tokens.numpy(), jt)
    for a, b in zip(res.logits, jl):
        np.testing.assert_allclose(a.float().numpy(), b, atol=1e-4, rtol=1e-4)


# ---------------------------------------------------------------------------
# training: 3 steps against build_train_step(..., constrain=None)
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("microbatches", [1, 2])
def test_train_step_matches_jax(microbatches):
    jcfg, cfg = _cfgs(MIXTRAL)
    jstate0 = jax.tree_util.tree_map(
        np.asarray, jax_steps.init_train_state(jax_build_model(jcfg), jax.random.key(0)))
    jtc = JaxTrainConfig(total_steps=10, warmup_steps=2, microbatches=microbatches)
    jstep = jax.jit(jax_steps.build_train_step(jax_build_model(jcfg), jtc,
                                               JaxLayout(attn_impl="flash"), constrain=None))
    tc = TrainConfig(total_steps=10, warmup_steps=2, microbatches=microbatches)
    step = steps.build_train_step(build_model(cfg), tc, ShardingLayout(attn_impl="flash"))
    jds, ds = JaxSyntheticLM(256, 32, 4, seed=0), SyntheticLM(256, 32, 4, seed=0)
    jstate = jax.tree_util.tree_map(jnp.asarray, jstate0)
    state = train_state_from_jax(jstate0, cfg, "cpu")
    for i in range(3):
        jstate, jm = jstep(jstate, {k: jnp.asarray(v) for k, v in jds.batch(i).items()})
        state, m = step(state, {k: torch.from_numpy(v) for k, v in ds.batch(i).items()})
        for k in ("loss", "aux_loss", "grad_norm"):
            np.testing.assert_allclose(float(m[k]), float(jm[k]), rtol=1e-4, err_msg=f"{k} {i}")
        assert float(m["aux_loss"]) > 0
    ours = train_state_to_numpy(state)
    ref = jax.tree_util.tree_map(np.asarray, jstate)
    for a, b in zip(jax.tree_util.tree_leaves(ours.params), jax.tree_util.tree_leaves(ref.params)):
        np.testing.assert_allclose(a, b, atol=1e-5, rtol=0)


def test_paged_decode_refuses_moe():
    m = build_model(get_arch(MIXTRAL).reduced())
    with pytest.raises(NotImplementedError, match="DENSE"):
        m.paged_cache_specs(8)
