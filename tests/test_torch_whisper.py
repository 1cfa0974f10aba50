"""The port's encoder-decoder (whisper-tiny) against the JAX package's, on
the CPU: LayerNorm and the biased GELU MLP, the encoder's memory (at the
reduced 16 frames, one fused attention block, and at 600, past the 512-row
chunk, where the keys are padded and masked), cross-attention, prefill and
greedy decode with the ``memory`` cache entry, three training steps with
frames in two microbatches, bf16 prefill, and what stays refused.

Reduced configs at f32 (bf16 where named), weights from the reference's
``init`` carried across by ``params_from_jax``. The reference initializes
every bias (``bi``, ``bo``, ``bq``/``bk``/``bv``, the LayerNorm ``bias``) to
zeros and every norm scale to ones, so a port that dropped one would pass
any comparison built on ``init``: every test here redraws them in both
packages first (``_drawn``: biases N(0, 0.5), scales 1 + N(0, 0.2)), and
``test_dropping_a_bias_fails`` shows that the comparison then sees them.
The training labels are the next tokens, never the tokens: a tied model
whose labels equal its tokens has a loss near 0 and a meaningless
gradient. Inputs are made with numpy from a seed. Tolerances (XLA and
torch sum in different orders): layers and the encoder's memory atol
1e-5; logits atol=rtol=1e-4 with identical greedy streams; training loss
and grad norm rtol 1e-4, params atol 1e-5; bf16 prefill logits at
atol=rtol=2e-2 in units of their standard deviation, with the same top-1.
"""
import dataclasses
import functools
from unittest import mock

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.config import ShardingLayout as JaxLayout
from repro.config import TrainConfig as JaxTrainConfig
from repro.config import get_arch as jax_get_arch
from repro.models import build_model as jax_build_model
from repro.models import layers as jax_layers
from repro.models import transformer as jax_transformer
from repro.train import steps as jax_steps
from repro_torch.config import ShardingLayout, TrainConfig, get_arch
from repro_torch.data import SyntheticLM
from repro_torch.launch import serve as serve_launcher
from repro_torch.launch import train as train_launcher
from repro_torch.models import RunOpts, build_model, layers, transformer, zoo
from repro_torch.models.convert import (
    params_from_jax,
    train_state_from_jax,
    train_state_to_numpy,
)
from repro_torch.train import steps
from repro_torch.train.loop import run_segment
from repro_torch.train.steps import init_train_state

WHISPER = "whisper-tiny"
F32, BF16 = "float32", "bfloat16"
NEW = 8
TOL = dict(atol=1e-4, rtol=1e-4)
BIASES = ("bias", "bi", "bo", "bq", "bk", "bv")


def _np(x):
    return x.float().numpy() if isinstance(x, torch.Tensor) else np.asarray(x, np.float32)


def _spec_fields(tree):
    if isinstance(tree, dict):
        return {k: _spec_fields(v) for k, v in tree.items()}
    return (tuple(tree.shape), tuple(tree.axes), tree.init, tree.scale, tree.dtype)


def _drawn(tree, rng):
    """``tree`` (numpy, JAX layout) with every bias leaf redrawn N(0, 0.5)
    and every norm ``scale`` 1 + N(0, 0.2); the other leaves are shared."""
    out = {}
    for k, v in tree.items():
        if isinstance(v, dict):
            out[k] = _drawn(v, rng)
        elif k in BIASES:
            out[k] = (0.5 * rng.randn(*v.shape)).astype(np.float32)
        elif k == "scale":
            out[k] = (1.0 + 0.2 * rng.randn(*v.shape)).astype(np.float32)
        else:
            out[k] = v
    return out


def _cfgs(dtype=F32, **change):
    return (dataclasses.replace(jax_get_arch(WHISPER).reduced(), dtype=dtype, **change),
            dataclasses.replace(get_arch(WHISPER).reduced(), dtype=dtype, **change))


@functools.lru_cache(maxsize=None)
def _jax_params(encoder_seq_len=16):
    jcfg, _ = _cfgs(encoder_seq_len=encoder_seq_len)
    tree = jax.tree_util.tree_map(np.asarray, jax_build_model(jcfg).init(jax.random.key(0)))
    return _drawn(tree, np.random.RandomState(1))


def _models(dtype=F32, encoder_seq_len=16):
    """(JAX model, JAX params, port model, port params), biases and scales drawn."""
    jcfg, cfg = _cfgs(dtype, encoder_seq_len=encoder_seq_len)
    tree = _jax_params(encoder_seq_len)
    return (jax_build_model(jcfg), jax.tree_util.tree_map(jnp.asarray, tree),
            build_model(cfg), params_from_jax(tree, cfg, "cpu"))


def _prompt(vocab, B, S, seed=0):
    return np.random.RandomState(seed).randint(0, vocab, (B, S)).astype(np.int32)


def _frames(cfg, B, seed=2):
    return np.random.RandomState(seed).randn(B, cfg.encoder_seq_len,
                                             cfg.d_model).astype(np.float32)


# ---------------------------------------------------------------------------
# configs and specs
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("reduced", [False, True])
def test_specs_match_jax(reduced):
    pick = (lambda c: c.reduced()) if reduced else (lambda c: c)
    cfg, jcfg = pick(get_arch(WHISPER)), pick(jax_get_arch(WHISPER))
    assert dataclasses.asdict(cfg) == dataclasses.asdict(jcfg)
    specs = build_model(cfg).specs
    assert _spec_fields(specs) == _spec_fields(jax_build_model(jcfg).specs)
    assert set(specs["blocks"]["ln1"]) == {"scale", "bias"}          # LayerNorm
    assert set(specs["blocks"]["mlp"]) == {"wi", "bi", "wo", "bo"}   # not gated
    assert "q_norm" not in specs["blocks"]["cross"]
    assert build_model(cfg).param_count() == jax_build_model(jcfg).param_count()
    for batch, seq in ((2, 36), (16, 192)):
        assert (_spec_fields(transformer.cache_specs(cfg, batch, seq))
                == _spec_fields(jax_transformer.cache_specs(jcfg, batch, seq)))


def test_full_width_param_count():
    """The model's specs count 36,477,312 params, the reference model's;
    the reference's analytic ``ModelConfig.param_count()`` (36,453,120)
    has no term for the MLP biases and the LayerNorm biases (24,192)."""
    cfg, jcfg = get_arch(WHISPER), jax_get_arch(WHISPER)
    assert build_model(cfg).param_count() == jax_build_model(jcfg).param_count() == 36_477_312
    assert jcfg.param_count() == 36_453_120
    assert (cfg.num_layers, cfg.encoder_layers, cfg.encoder_seq_len, cfg.d_model) == (
        4, 4, 1500, 384)


@pytest.mark.parametrize("mode", ["train", "prefill", "decode"])
def test_input_specs_give_frames(mode):
    cfg = get_arch(WHISPER)
    specs = zoo.input_specs(cfg, 16, 64, mode)
    assert specs["frames"] == ((16, 1500, 384), torch.bfloat16)
    assert specs["tokens"][0] == (16, 1 if mode == "decode" else 64)
    assert ("labels" in specs) == (mode == "train") and "patches" not in specs


# ---------------------------------------------------------------------------
# layers
# ---------------------------------------------------------------------------

def _layer_params(spec_tree, seed):
    """One layer's params from numpy: matrices fan-in scaled, as ``init``
    draws them; biases N(0, 0.5) and scales 1 + N(0, 0.2), unlike it."""
    rng = np.random.RandomState(seed)

    def draw(k, s):
        if len(s.shape) == 2:
            return rng.randn(*s.shape) / np.sqrt(s.shape[0])
        return rng.randn(*s.shape) * (0.5 if k in BIASES else 0.2) + (k == "scale")

    one = {k: draw(k, s).astype(np.float32) for k, s in spec_tree.items()}
    return ({k: jnp.asarray(v) for k, v in one.items()},
            {k: torch.from_numpy(v.copy()) for k, v in one.items()})


def test_layernorm_and_norm_dispatch_match_jax():
    jcfg, cfg = _cfgs()
    jp, tp = _layer_params(layers.layernorm_spec(cfg.d_model), 3)
    x = (3.0 + 2.0 * np.random.RandomState(4).randn(2, 7, cfg.d_model)).astype(np.float32)
    want = jax_layers.layernorm(jp, jnp.asarray(x), jcfg.norm_eps)
    for got in (layers.layernorm(tp, torch.from_numpy(x), cfg.norm_eps),
                layers.norm(tp, torch.from_numpy(x), cfg)):
        np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=1e-5, rtol=0)
    rp = {"scale": tp["scale"]}       # no bias: the dispatch takes RMSNorm
    np.testing.assert_allclose(
        layers.norm(rp, torch.from_numpy(x), cfg).numpy(),
        np.asarray(jax_layers.norm({"scale": jp["scale"]}, jnp.asarray(x), jcfg)),
        atol=1e-5, rtol=0)
    xb = torch.from_numpy(x).to(torch.bfloat16)
    assert layers.layernorm(tp, xb, cfg.norm_eps).dtype == torch.bfloat16


def test_biased_gelu_mlp_matches_jax():
    jcfg, cfg = _cfgs()
    jp, tp = _layer_params(layers.mlp_spec(cfg), 5)
    x = np.random.RandomState(6).randn(2, 7, cfg.d_model).astype(np.float32)
    want = jax_layers.mlp(jp, jnp.asarray(x), jcfg)
    np.testing.assert_allclose(layers.mlp(tp, torch.from_numpy(x), cfg).numpy(),
                               np.asarray(want), atol=1e-5, rtol=0)


@pytest.mark.parametrize("T", [16, 600])
def test_cross_attention_matches_jax(T):
    """Queries over a memory of T rows: 600 is past the 512-row chunk, so
    the keys are padded to 1024 and the pad rows masked (1500 frames go
    the same way to 1536)."""
    jcfg, cfg = _cfgs()
    jp, tp = _layer_params(layers.attention_spec(cfg, cross=True), 7)
    rng = np.random.RandomState(8)
    x = rng.randn(2, 5, cfg.d_model).astype(np.float32)
    mem = rng.randn(2, T, cfg.d_model).astype(np.float32)
    want = jax_layers.cross_attention_layer(jp, jnp.asarray(x), jnp.asarray(mem), jcfg)
    got = layers.cross_attention_layer(tp, torch.from_numpy(x), torch.from_numpy(mem), cfg)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=1e-5, rtol=0)


@pytest.mark.parametrize("T", [16, 600])
def test_encoder_memory_matches_jax(T):
    """The encoder over T frames: 16 is one fused block; 600 pads the keys
    and the queries to 1024 and masks the pad rows."""
    jm, jp, m, p = _models(encoder_seq_len=T)
    fr = _frames(m.cfg, 2)
    want = jax_transformer._run_encoder(jp["encoder"], jnp.asarray(fr), jm.cfg)
    got = transformer._run_encoder(p["encoder"], torch.from_numpy(fr), m.cfg)
    assert tuple(got.shape) == (2, T, m.cfg.d_model)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=1e-5, rtol=0)


# ---------------------------------------------------------------------------
# prefill + decode
# ---------------------------------------------------------------------------

@functools.lru_cache(maxsize=None)
def _jax_greedy(B, S, T):
    jm, jp, _, _ = _models(encoder_seq_len=T)
    batch = {"tokens": jnp.asarray(_prompt(jm.cfg.vocab_size, B, S)),
             "frames": jnp.asarray(_frames(jm.cfg, B))}
    logits, cache = jax.jit(lambda p, b: jm.prefill(p, b, S + NEW))(jp, batch)
    decode = jax.jit(jm.decode_step)
    toks, outs = [], []
    for i in range(NEW + 1):
        outs.append(np.asarray(logits[:, -1], np.float32))
        tok = jnp.argmax(logits[:, -1], axis=-1).astype(jnp.int32)[:, None]
        toks.append(np.asarray(tok))
        if i < NEW:
            logits, cache = decode(jp, cache, tok, jnp.int32(S + i))
    return np.concatenate(toks, axis=1), outs, jax.tree_util.tree_map(np.asarray, cache)


def _port_greedy(B, S, T, opts=RunOpts()):
    _, _, m, p = _models(encoder_seq_len=T)
    batch = {"tokens": torch.as_tensor(_prompt(m.cfg.vocab_size, B, S)),
             "frames": torch.from_numpy(_frames(m.cfg, B))}
    logits, cache = m.prefill(p, batch, S + NEW, opts)
    memory = cache["memory"].clone()
    toks, outs = [], []
    for i in range(NEW + 1):
        outs.append(_np(logits[:, -1]))
        tok = logits[:, -1].argmax(-1).to(torch.int32)[:, None]
        toks.append(tok.numpy())
        if i < NEW:
            logits, cache = m.decode_step(p, cache, tok, S + i, opts)
    assert torch.equal(cache["memory"], memory)     # decode reads it, never writes it
    return np.concatenate(toks, axis=1), outs, cache


@pytest.mark.parametrize("T,attn_impl", [(16, "masked"), (16, "flash"), (600, "flash")])
def test_prefill_decode_matches_jax(T, attn_impl):
    """B=2, a 12-token prompt, prefill + 8 decode steps: logits at every
    step, the greedy streams, and the cache's memory and k."""
    jt, jl, jc = _jax_greedy(2, 12, T)
    tt, tl, tc = _port_greedy(2, 12, T, RunOpts(attn_impl=attn_impl, q_chunk=8, kv_chunk=8))
    for i, (a, b) in enumerate(zip(tl, jl)):
        np.testing.assert_allclose(a, b, **TOL, err_msg=f"step {i}")
    assert np.array_equal(tt, jt)
    np.testing.assert_allclose(_np(tc["memory"]), jc["memory"], atol=1e-5, rtol=0)
    np.testing.assert_allclose(_np(tc["blocks"]["k"]), jc["blocks"]["k"], **TOL)


def test_serve_launcher_greedy_matches_decode_loop():
    """``greedy_serve(frames=...)``, the launcher's loop, gives the streams
    of the decode loop above."""
    _, _, m, p = _models()
    toks = torch.as_tensor(_prompt(m.cfg.vocab_size, 2, 12))
    res = serve_launcher.greedy_serve(m, p, toks, NEW + 1, ShardingLayout(),
                                      frames=torch.from_numpy(_frames(m.cfg, 2)))
    jt, _, _ = _jax_greedy(2, 12, 16)
    assert np.array_equal(res.tokens.numpy(), jt)


def test_dropping_a_bias_fails():
    """A port whose MLP forgot ``bo`` (everything else equal) misses the
    reference's prefill logits by far more than the tolerance: the drawn
    biases make the comparisons above see every add."""
    real = layers.mlp

    def no_bo(params, x, cfg):
        return real(dict(params, bo=torch.zeros_like(params["bo"])), x, cfg)

    _, jl, _ = _jax_greedy(2, 12, 16)
    with mock.patch.object(layers, "mlp", no_bo):
        _, tl, _ = _port_greedy(2, 12, 16)
    assert float(np.abs(tl[0] - jl[0]).max()) > 100 * TOL["atol"]


def test_bf16_prefill_matches_jax():
    """bf16 weights and frames: the last logits within 2e-2 of their
    standard deviation of the reference's, the same top-1."""
    jcfg, cfg = _cfgs(BF16)
    tree = _jax_params(16)
    toks = _prompt(cfg.vocab_size, 2, 12)
    fr = _frames(cfg, 2)
    want, _ = jax_build_model(jcfg).prefill(
        jax.tree_util.tree_map(jnp.asarray, tree),
        {"tokens": jnp.asarray(toks), "frames": jnp.asarray(fr, jnp.bfloat16)}, 20)
    got, cache = build_model(cfg).prefill(
        params_from_jax(tree, cfg, "cpu", torch.bfloat16),
        {"tokens": torch.from_numpy(toks), "frames": torch.from_numpy(fr).to(torch.bfloat16)},
        20, RunOpts(attn_impl="flash"))
    assert cache["memory"].dtype == torch.bfloat16
    # the repository's bf16 tolerance in units of the logits' std (XLA and
    # torch round bf16 at other places), as tests/test_torch_gemma.py holds it
    a, b = _np(got[:, -1]), np.asarray(want[:, -1], np.float32)
    scale = float(b.std())
    np.testing.assert_allclose(a / scale, b / scale, atol=2e-2, rtol=2e-2)
    assert np.array_equal(a.argmax(-1), b.argmax(-1))


# ---------------------------------------------------------------------------
# training: 3 steps against build_train_step(..., constrain=None)
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("attn_impl", ["masked", "flash"])
def test_train_step_matches_jax(attn_impl):
    """3 steps of batch 4 in 2 microbatches, tokens and next-token labels
    (never equal) with frames: loss and grad norm at every step, then
    params (every bias moved from its start) and moments."""
    jcfg, cfg = _cfgs()
    jstate0 = jax.tree_util.tree_map(
        np.asarray, jax_steps.init_train_state(jax_build_model(jcfg), jax.random.key(0)))
    jstate0 = jstate0._replace(params=_jax_params(16))
    jtc = JaxTrainConfig(total_steps=10, warmup_steps=2, microbatches=2)
    jstep = jax.jit(jax_steps.build_train_step(
        jax_build_model(jcfg), jtc, JaxLayout(attn_impl="masked", q_chunk=16, kv_chunk=16),
        constrain=None))
    tc = TrainConfig(total_steps=10, warmup_steps=2, microbatches=2)
    step = steps.build_train_step(build_model(cfg), tc,
                                  ShardingLayout(attn_impl=attn_impl, q_chunk=16, kv_chunk=16))
    ds = SyntheticLM(cfg.vocab_size, 24, 4, seed=0)
    jstate = jax.tree_util.tree_map(jnp.asarray, jstate0)
    state = train_state_from_jax(jstate0, cfg, "cpu")
    for i in range(3):
        batch = dict(ds.batch(i), frames=np.random.RandomState(20 + i).randn(
            4, cfg.encoder_seq_len, cfg.d_model).astype(np.float32))
        assert (batch["labels"] != batch["tokens"]).mean() > 0.5
        jstate, jm = jstep(jstate, {k: jnp.asarray(v) for k, v in batch.items()})
        state, m = step(state, {k: torch.from_numpy(v) for k, v in batch.items()})
        for k in ("loss", "grad_norm"):
            np.testing.assert_allclose(float(m[k]), float(jm[k]), rtol=1e-4, err_msg=f"{k} {i}")
    ours, ref = train_state_to_numpy(state), jax.tree_util.tree_map(np.asarray, jstate)
    # cross-attention's key bias has no RoPE, so it adds q . bk to every
    # score of a query row, which the softmax ignores: its gradient is 0 up
    # to rounding, in both packages, and AdamW scales that rounding noise
    # up to a step of the learning rate's order (1.8e-5 apart here). Its
    # moments are held near 0 instead of its value.
    noise_only = lambda path: jax.tree_util.keystr(path) == "['blocks']['cross']['bk']"
    for tree, want in ((ours.params, ref.params), (ours.opt.m, ref.opt.m)):
        for (path, b), a in zip(jax.tree_util.tree_leaves_with_path(want),
                                jax.tree_util.tree_leaves(tree)):
            if not noise_only(path):
                np.testing.assert_allclose(a, b, atol=1e-5, rtol=0, err_msg=str(path))
    for m_tree in (ours.opt.m, ref.opt.m):
        assert float(np.abs(m_tree["blocks"]["cross"]["bk"]).max()) < 1e-9
    start = jstate0.params
    for path, (a, b) in (("encoder mlp bo", (ours.params["encoder"]["blocks"]["mlp"]["bo"],
                                             start["encoder"]["blocks"]["mlp"]["bo"])),
                         ("cross bq", (ours.params["blocks"]["cross"]["bq"],
                                       start["blocks"]["cross"]["bq"])),
                         ("ln_cross bias", (ours.params["blocks"]["ln_cross"]["bias"],
                                            start["blocks"]["ln_cross"]["bias"]))):
        assert float(np.abs(a - b).max()) > 0, path


# ---------------------------------------------------------------------------
# what stays refused
# ---------------------------------------------------------------------------

def test_paged_decode_refuses_encoder_decoder():
    _, _, m, p = _models()
    with pytest.raises(NotImplementedError, match="DENSE"):
        m.paged_cache_specs(8)
    with pytest.raises(NotImplementedError, match="DENSE"):
        m.decode_step_paged(p, {}, torch.zeros((1, 1), dtype=torch.int32),
                            torch.zeros((1,), dtype=torch.int32),
                            torch.zeros((1, 1), dtype=torch.int32))


@pytest.mark.parametrize("extra", [[], ["--engine"]])
def test_serve_plan_refuses_encoder_decoder(extra):
    """The dense plans serve whisper since its memory rides in the cache
    (held against the reference's ``plan_main`` in
    ``tests/test_torch_whisper_plan.py``); the engine still refuses it, as
    the reference's paged cache refuses any non-DENSE block."""
    argv = ["--arch", WHISPER, "--device", "cpu", "--plan", "8,4", "--batch", "2",
            "--prompt-len", "8", "--new-tokens", "3", *extra]
    if extra:
        with pytest.raises(NotImplementedError, match="DENSE"):
            serve_launcher.main(argv)
    else:
        out = serve_launcher.main(argv)
        assert np.asarray(out["tokens"]).shape == (2, 3) and out["migrated_at"] is None


def test_train_launcher_and_run_segment_refuse_encoder_decoder():
    with pytest.raises(SystemExit, match="frames"):
        train_launcher.main(["--arch", WHISPER, "--device", "cpu", "--steps", "1"])
    _, cfg = _cfgs()
    model = build_model(cfg)
    state = init_train_state(model, torch.Generator().manual_seed(0), "cpu")
    with pytest.raises(NotImplementedError, match="frames"):
        run_segment(model, state, SyntheticLM(cfg.vocab_size, 8, 2, seed=0), "cpu",
                    TrainConfig(), ShardingLayout(), num_steps=1)
