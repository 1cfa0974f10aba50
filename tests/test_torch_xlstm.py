"""The port's xLSTM serving path (reduced xlstm-350m) against the JAX
package's, on the CPU: specs and cache specs, parameter and cache
conversion, the serving dtypes, the mLSTM and sLSTM blocks, ``prefill`` +
``decode_step``, and the serve launcher.

The oracle is the JAX ``Model`` with default ``RunOpts()`` under
``jax.jit`` and no mesh. Params come from ``Model.init(jax.random.key(0))``
and go across with ``params_from_jax``; prompts and block inputs are made
with numpy from a seed. On the CPU the mLSTM runs the plain chunkwise form
(``mlstm_chunkwise_ref``), which pads a ragged S where the JAX scan falls
back to chunk 1. Tolerances: f32 atol=rtol=1e-4 (XLA and torch sum
matmuls in different orders) with greedy streams identical; bf16 top-1
equal at every step under teacher forcing.
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
from repro.models import transformer as jax_transformer
from repro.models import xlstm as jax_xlstm
from repro_torch.config import AttentionKind, BlockKind, ShardingLayout, SSMConfig, get_arch
from repro_torch.launch import serve as serve_launcher
from repro_torch.models import build_model, transformer, xlstm
from repro_torch.models.convert import (
    cache_from_jax, cache_to_numpy, params_from_jax, params_to_numpy,
)

F32, BF16 = "float32", "bfloat16"
XLSTM = "xlstm-350m"
NEW = 16
TOL = dict(atol=1e-4, rtol=1e-4)


def _np(x):
    return x.float().numpy() if isinstance(x, torch.Tensor) else np.asarray(x, np.float32)


def _spec_fields(tree):
    if isinstance(tree, dict):
        return {k: _spec_fields(v) for k, v in tree.items()}
    return (tuple(tree.shape), tuple(tree.axes), tree.init, tree.scale, tree.dtype)


def _at(tree, path):
    return functools.reduce(lambda t, k: t[k.key], path, tree)


@functools.lru_cache(maxsize=None)
def _jax_params():
    cfg = jax_get_arch(XLSTM).reduced()
    return jax.tree_util.tree_map(np.asarray, jax_build_model(cfg).init(jax.random.key(0)))


def _cfgs(dtype=F32):
    return (dataclasses.replace(get_arch(XLSTM).reduced(), dtype=dtype),
            dataclasses.replace(jax_get_arch(XLSTM).reduced(), dtype=dtype))


def _prompt(vocab, B, S, seed=0):
    return np.random.RandomState(seed).randint(0, vocab, (B, S)).astype(np.int32)


# ---------------------------------------------------------------------------
# config, specs, conversion
# ---------------------------------------------------------------------------

def test_config_matches_jax_field_for_field():
    cfg, jcfg = get_arch(XLSTM), jax_get_arch(XLSTM)
    for f in dataclasses.fields(cfg):
        a, b = getattr(cfg, f.name), getattr(jcfg, f.name)
        if f.name in ("attention", "block"):
            a, b = a.value, b.value
        elif f.name == "ssm":
            a, b = dataclasses.asdict(a), dataclasses.asdict(b)
        assert a == b, f.name
    assert (cfg.block, cfg.attention, cfg.slstm_every, cfg.ssm) == (
        BlockKind.MLSTM, AttentionKind.NONE, 6, SSMConfig(chunk=256))
    red = cfg.reduced()
    assert (red.slstm_every, red.num_layers, red.ssm.chunk, red.d_model) == (2, 4, 8, 128)


@pytest.mark.parametrize("reduced", [False, True])
def test_specs_match_jax(reduced):
    pick = (lambda c: c.reduced()) if reduced else (lambda c: c)
    cfg, jcfg = pick(get_arch(XLSTM)), pick(jax_get_arch(XLSTM))
    assert _spec_fields(build_model(cfg).specs) == _spec_fields(jax_build_model(jcfg).specs)
    assert build_model(cfg).param_count() == jax_build_model(jcfg).param_count()
    for batch, seq in ((2, 36), (8, 4128)):
        assert (_spec_fields(transformer.cache_specs(cfg, batch, seq))
                == _spec_fields(jax_transformer.cache_specs(jcfg, batch, seq)))


def test_full_width_shape():
    cfg = get_arch(XLSTM)
    assert transformer._xlstm_group_layout(cfg) == (4, 5, 1)
    assert xlstm._mdims(cfg) == (4, 2048, 512)
    assert build_model(cfg).param_count() == 527_017_120
    C = transformer.cache_specs(cfg, 8, 4128)["groups"]["mlstm"]["C"]
    assert C.shape == (4, 5, 8, 4, 512, 512) and C.axes[:2] == ("groups", "layers")


def test_init_cache_matches_jax():
    cfg, jcfg = get_arch(XLSTM).reduced(), jax_get_arch(XLSTM).reduced()
    tc = cache_to_numpy(build_model(cfg).init_cache(2, 36, "cpu"))
    jc = jax.tree_util.tree_map(np.asarray, jax_build_model(jcfg).init_cache(2, 36))
    flat = jax.tree_util.tree_leaves_with_path(jc)
    assert len(flat) == len(jax.tree_util.tree_leaves(tc)) == 7
    for path, a in flat:
        assert np.array_equal(a, _at(tc, path)), path


def test_params_round_trip():
    cfg = get_arch(XLSTM).reduced()
    back = params_to_numpy(params_from_jax(_jax_params(), cfg, "cpu"))
    for path, a in jax.tree_util.tree_leaves_with_path(_jax_params()):
        assert np.array_equal(a, _at(back, path)), path


def test_cache_round_trip_from_jax():
    """A JAX prefill cache (f32 mLSTM and sLSTM states, stacked over groups
    and layers) comes across exactly and back, and a decode step from it
    matches JAX's."""
    cfg, jcfg = _cfgs()
    jm, m = jax_build_model(jcfg), build_model(cfg)
    jp = jax.tree_util.tree_map(jnp.asarray, _jax_params())
    toks = _prompt(cfg.vocab_size, 2, 16)
    _, jcache = jax.jit(lambda p, b: jm.prefill(p, b, 16 + NEW))(jp, {"tokens": toks})
    tcache = cache_from_jax(jax.tree_util.tree_map(np.asarray, jcache), cfg, 2, 16 + NEW, "cpu")
    assert all(t.dtype == torch.float32 for t in jax.tree_util.tree_leaves(tcache))
    back = cache_to_numpy(tcache)
    for path, a in jax.tree_util.tree_leaves_with_path(jcache):
        assert np.array_equal(np.asarray(a), _at(back, path)), path
    tok = np.asarray([[3], [7]], np.int32)
    jl, _ = jax.jit(jm.decode_step)(jp, jcache, jnp.asarray(tok), jnp.int32(16))
    tl, _ = m.decode_step(params_from_jax(_jax_params(), cfg, "cpu"), tcache,
                          torch.as_tensor(tok), 16)
    np.testing.assert_allclose(_np(tl), _np(jl), **TOL)


def _dtypes(tree, prefix=""):
    if isinstance(tree, dict):
        return {k: v for key, sub in tree.items() for k, v in _dtypes(sub, f"{prefix}{key}.").items()}
    return {prefix[:-1]: tree.dtype}


def test_serving_dtype_keeps_f32_leaves():
    """Stored for bf16 serving, ``w_if``, ``w_gates`` and ``r_gates`` (read
    in f32 by the blocks) stay f32, by ``Model.init`` and by
    ``params_from_jax``; the other matrices are bf16, norms and biases f32."""
    cfg = get_arch(XLSTM).reduced()
    made = build_model(cfg).init(torch.Generator().manual_seed(0), "cpu", torch.bfloat16)
    carried = params_from_jax(_jax_params(), cfg, "cpu", dtype=torch.bfloat16)
    for params in (made, carried):
        bf16 = {k for k, v in _dtypes(params).items() if v == torch.bfloat16}
        assert bf16 == {"embed", "lm_head", "groups.mlstm.block.up_proj",
                        "groups.mlstm.block.wq", "groups.mlstm.block.wk",
                        "groups.mlstm.block.wv", "groups.mlstm.block.down_proj",
                        "groups.slstm.block.up_proj", "groups.slstm.block.down_proj"}
        for k in ("groups.mlstm.block.w_if", "groups.slstm.block.w_gates",
                  "groups.slstm.block.r_gates"):
            assert _dtypes(params)[k] == torch.float32, k


# ---------------------------------------------------------------------------
# the blocks
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("with_state", [False, True])
@pytest.mark.parametrize("kind", ["mlstm", "slstm"])
def test_block_matches_jax_f32(kind, with_state):
    """Group 0's block (layer 0 for the mLSTM) on x (2, 13, d): 13 is
    ragged against chunk 8; with a state from a first call on 5 tokens."""
    cfg, jcfg = _cfgs()
    take = (lambda a: a[0, 0]) if kind == "mlstm" else (lambda a: a[0])
    jp = jax.tree_util.tree_map(lambda a: jnp.asarray(take(a)), _jax_params()["groups"][kind])
    tp = transformer.layer_slice(params_from_jax(_jax_params(), cfg, "cpu")["groups"], 0)[kind]
    if kind == "mlstm":
        tp = transformer.layer_slice(tp, 0)
    jfn, tfn = getattr(jax_xlstm, f"{kind}_block"), getattr(xlstm, f"{kind}_block")
    rng = np.random.RandomState(21)
    x0 = rng.randn(2, 5, cfg.d_model).astype(np.float32)
    x = rng.randn(2, 13, cfg.d_model).astype(np.float32)
    jst = tst = None
    if with_state:
        _, jst = jax.jit(lambda p, xx: jfn(p["block"], xx, jcfg))(jp, jnp.asarray(x0))
        _, tst = tfn(tp["block"], torch.from_numpy(x0), cfg)
    jy, jnew = jax.jit(lambda p, xx, st: jfn(p["block"], xx, jcfg, state=st))(
        jp, jnp.asarray(x), jst)
    ty, tnew = tfn(tp["block"], torch.from_numpy(x), cfg, tst)
    np.testing.assert_allclose(_np(ty), _np(jy), **TOL)
    assert set(tnew) == set(jnew)
    for key in jnew:
        assert tnew[key].dtype == torch.float32 and tuple(tnew[key].shape) == jnew[key].shape
        np.testing.assert_allclose(_np(tnew[key]), _np(jnew[key]), err_msg=key, **TOL)


# ---------------------------------------------------------------------------
# the model: prefill + decode_step against the JAX Model
# ---------------------------------------------------------------------------

@functools.lru_cache(maxsize=None)
def _jax_greedy(dtype, B, S, feed=None):
    """The JAX greedy loop: jitted prefill, then jitted decode_step at
    positions S, S+1, ...; ``feed`` (per-step token rows) replaces the
    sampled tokens (teacher forcing). Returns (tokens (B, NEW), per-step
    logits, the prefill's cache), numpy."""
    _, jcfg = _cfgs(dtype)
    model = jax_build_model(jcfg)
    params = jax.tree_util.tree_map(jnp.asarray, _jax_params())
    decode = jax.jit(model.decode_step)
    logits, cache = jax.jit(lambda p, b: model.prefill(p, b, S + NEW))(
        params, {"tokens": jnp.asarray(_prompt(jcfg.vocab_size, B, S))})
    prefill_cache = jax.tree_util.tree_map(lambda a: np.asarray(a, np.float32), cache)
    toks, outs = [], []
    for i in range(NEW):
        outs.append(np.asarray(logits[:, -1], np.float32))
        tok = jnp.argmax(logits[:, -1], axis=-1).astype(jnp.int32)[:, None]
        toks.append(np.asarray(tok))
        if feed is not None:
            tok = jnp.asarray(np.asarray(feed[i], np.int32)[:, None])
        if i + 1 < NEW:
            logits, cache = decode(params, cache, tok, jnp.int32(S + i))
    return np.concatenate(toks, axis=1), outs, prefill_cache


def _port_greedy(dtype, B, S, feed=None):
    cfg, _ = _cfgs(dtype)
    model = build_model(cfg)
    params = params_from_jax(_jax_params(), cfg, "cpu",
                             dtype=torch.bfloat16 if dtype == BF16 else None)
    logits, cache = model.prefill(
        params, {"tokens": torch.as_tensor(_prompt(cfg.vocab_size, B, S))}, S + NEW)
    prefill_cache = cache_to_numpy(cache)
    toks, outs = [], []
    for i in range(NEW):
        outs.append(_np(logits[:, -1]))
        tok = logits[:, -1].argmax(-1).to(torch.int32)[:, None]
        toks.append(tok.numpy())
        if feed is not None:
            tok = torch.as_tensor(np.asarray(feed[i], np.int32)[:, None])
        if i + 1 < NEW:
            logits, cache = model.decode_step(params, cache, tok, S + i)
    return np.concatenate(toks, axis=1), outs, prefill_cache


@pytest.mark.parametrize("S", [16, 12])
def test_prefill_matches_jax_f32(S):
    """S=16 is two whole chunks of 8; S=12 is ragged (the port pads, the
    JAX scan takes chunk 1). Logits and every cache leaf at 1e-4."""
    _, jl, jc = _jax_greedy(F32, 2, S)
    _, tl, tc = _port_greedy(F32, 2, S)
    np.testing.assert_allclose(tl[0], jl[0], **TOL)
    assert set(tc) == {"groups"} and set(tc["groups"]) == {"mlstm", "slstm"}
    flat = jax.tree_util.tree_leaves_with_path(jc)
    assert len(flat) == len(jax.tree_util.tree_leaves(tc)) == 7
    for path, a in flat:
        b = _at(tc, path)
        assert b.shape == a.shape, path
        np.testing.assert_allclose(b, a, err_msg=str(path), **TOL)


def test_greedy_stream_matches_jax_f32():
    """16 greedy tokens through ``decode_step`` (the state updated in place)."""
    jt, jl, _ = _jax_greedy(F32, 2, 16)
    tt, tl, _ = _port_greedy(F32, 2, 16)
    for i, (a, b) in enumerate(zip(tl, jl)):
        np.testing.assert_allclose(a, b, err_msg=f"step {i}", **TOL)
    assert np.array_equal(tt, jt)


def test_bf16_top1_matches_jax():
    """bf16: both stacks fed the JAX stream agree on top-1 at every step."""
    jt, _, _ = _jax_greedy(BF16, 2, 16)
    feed = tuple(map(tuple, jt.T))
    j_tops, _, _ = _jax_greedy(BF16, 2, 16, feed=feed)
    t_tops, _, _ = _port_greedy(BF16, 2, 16, feed=feed)
    assert np.array_equal(t_tops, j_tops)


# ---------------------------------------------------------------------------
# the serve launcher, and what the port refuses
# ---------------------------------------------------------------------------

def test_greedy_serve_matches_jax_greedy_loop():
    jt, jl, _ = _jax_greedy(F32, 2, 16)
    cfg, _ = _cfgs()
    model = build_model(cfg)
    res = serve_launcher.greedy_serve(
        model, params_from_jax(_jax_params(), cfg, "cpu"),
        torch.as_tensor(_prompt(cfg.vocab_size, 2, 16)), NEW, ShardingLayout(attn_impl="flash"))
    assert np.array_equal(res.tokens.numpy(), jt) and res.decode_steps == NEW - 1
    for a, b in zip(res.logits, jl):
        np.testing.assert_allclose(_np(a), b, **TOL)
    assert set(res.cache) == {"groups"}


def test_host_main_serves_xlstm_on_cpu(capsys):
    args = SimpleNamespace(arch=XLSTM, batch=2, prompt_len=12, new_tokens=4, reduced=True,
                           device="cpu", seed=0, int8_cache=False, plan="", engine=False,
                           trace="")
    out = serve_launcher.host_main(args)
    assert out["arch"] == "xlstm-350m-reduced" and out["device"] == "cpu"
    assert len(out["first_row"]) == 4 and all(0 <= t < 256 for t in out["first_row"])
    assert '"serve done"' in capsys.readouterr().out


def test_xlstm_forwards_run_paged_decode_and_slstm_refuse():
    """The training forwards run for xLSTM since the mLSTM has a gradient
    (``test_forward_matches_jax_f32`` holds them against the JAX package);
    the paged decode (DENSE only, as in the reference) still refuses. A
    model of BlockKind.SLSTM blocks builds since it was ported, laid out
    as this one (``tests/test_torch_slstm_kind.py``); a MAMBA one, which
    no config uses, still refuses."""
    cfg = get_arch(XLSTM).reduced()
    m = build_model(cfg)
    params = m.init(torch.Generator().manual_seed(0), "cpu")
    batch = {"tokens": torch.zeros((1, 8), dtype=torch.int32)}
    x, aux = m.forward_hidden(params, batch)
    assert tuple(x.shape) == (1, 8, cfg.d_model) and float(aux) == 0.0
    assert tuple(m.forward(params, batch)[0].shape) == (1, 8, cfg.vocab_size)
    with pytest.raises(NotImplementedError, match="DENSE"):
        m.paged_cache_specs(8)
    slstm = build_model(dataclasses.replace(cfg, block=BlockKind.SLSTM))
    assert _spec_fields(slstm.specs) == _spec_fields(m.specs)
    with pytest.raises(NotImplementedError):
        build_model(dataclasses.replace(cfg, block=BlockKind.MAMBA))


@pytest.mark.parametrize("S", [16, 12])
def test_forward_matches_jax_f32(S):
    """``forward_hidden`` (the normed hidden states and the aux loss, 0) and
    ``forward`` (the logits) over every position against the JAX Model's,
    f32, S=16 two whole chunks of 8, S=12 ragged (JAX's chunk 1)."""
    cfg, jcfg = _cfgs()
    params = params_from_jax(_jax_params(), cfg, "cpu")
    jm, m = jax_build_model(jcfg), build_model(cfg)
    tokens = _prompt(cfg.vocab_size, 2, S, seed=S)
    jx, jaux = jm.forward_hidden(_jax_params(), {"tokens": jnp.asarray(tokens)})
    x, aux = m.forward_hidden(params, {"tokens": torch.as_tensor(tokens)})
    np.testing.assert_allclose(_np(x), _np(jx), **TOL)
    assert float(aux) == float(jaux) == 0.0
    jl, _ = jm.forward(_jax_params(), {"tokens": jnp.asarray(tokens)})
    tl, _ = m.forward(params, {"tokens": torch.as_tensor(tokens)})
    np.testing.assert_allclose(_np(tl), _np(jl), **TOL)
