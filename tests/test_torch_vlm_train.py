"""The VLM's training step (reduced internvl2-26b with its stub patch
embeddings) in the port against the JAX package's, on the CPU.

``build_train_step`` takes a batch that carries ``patches`` (B,
vision_tokens, vision_width) beside the tokens: the microbatch split
slices them with every other key, ``vision_proj`` projects them into the
prefix, and the prefix is sliced off before the chunked cross-entropy,
as in the reference.

* Three steps at f32 (batch 4 in 2 microbatches, 8 patch rows + 24
  tokens, next-token labels) against ``jax.jit(build_train_step(...,
  constrain=None))``: loss and grad norm rtol 1e-4 at every step, params
  and first moments atol 1e-5; ``vision_proj`` moved.
* ``vision_proj``'s gradient from one backward through the port's loss
  against ``jax.grad`` of the reference's, atol 1e-5.
* ``run_segment`` and the training launcher refuse a VLM, as they refuse
  an encoder-decoder: the data path makes no patches.

Weights from the reference's ``Model.init(jax.random.key(0))`` carried
across by ``train_state_from_jax``; tokens from ``SyntheticLM``, patches
standard normal from numpy, both seeded.
"""
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
from repro.models import build_model as jax_build_model
from repro.train import steps as jax_steps
from repro_torch.config import ShardingLayout, TrainConfig, get_arch
from repro_torch.data import SyntheticLM
from repro_torch.launch import train as train_launcher
from repro_torch.models import RunOpts, build_model
from repro_torch.models.convert import params_from_jax, train_state_from_jax, train_state_to_numpy
from repro_torch.train import steps
from repro_torch.train.loop import run_segment

VLM = "internvl2-26b"
B, S = 4, 24


def _cfgs():
    return (dataclasses.replace(jax_get_arch(VLM).reduced(), dtype="float32"),
            dataclasses.replace(get_arch(VLM).reduced(), dtype="float32"))


@functools.lru_cache(maxsize=None)
def _jax_state():
    jcfg, _ = _cfgs()
    return jax.tree_util.tree_map(
        np.asarray, jax_steps.init_train_state(jax_build_model(jcfg), jax.random.key(0)))


def _batch(i):
    _, cfg = _cfgs()
    out = SyntheticLM(cfg.vocab_size, S, B, seed=0).batch(i)
    out["patches"] = np.random.RandomState(30 + i).randn(
        B, cfg.vision_tokens, cfg.vision_width).astype(np.float32)
    return out


def test_vlm_train_steps_match_jax():
    jcfg, cfg = _cfgs()
    assert cfg.vision_tokens == 8 and cfg.vision_width == 64
    jtc = JaxTrainConfig(total_steps=10, warmup_steps=2, microbatches=2)
    jstep = jax.jit(jax_steps.build_train_step(
        jax_build_model(jcfg), jtc, JaxLayout(q_chunk=16, kv_chunk=16), constrain=None))
    tc = TrainConfig(total_steps=10, warmup_steps=2, microbatches=2)
    step = steps.build_train_step(build_model(cfg), tc,
                                  ShardingLayout(attn_impl="flash", q_chunk=16, kv_chunk=16))
    jstate = jax.tree_util.tree_map(jnp.asarray, _jax_state())
    state = train_state_from_jax(_jax_state(), cfg, "cpu")
    for i in range(3):
        batch = _batch(i)
        assert (batch["labels"] != batch["tokens"]).mean() > 0.5
        jstate, jm = jstep(jstate, {k: jnp.asarray(v) for k, v in batch.items()})
        state, m = step(state, {k: torch.from_numpy(v) for k, v in batch.items()})
        for k in ("loss", "grad_norm"):
            np.testing.assert_allclose(float(m[k]), float(jm[k]), rtol=1e-4, err_msg=f"{k} {i}")
    ours, ref = train_state_to_numpy(state), jax.tree_util.tree_map(np.asarray, jstate)
    for tree, want in ((ours.params, ref.params), (ours.opt.m, ref.opt.m)):
        for (path, b), a in zip(jax.tree_util.tree_leaves_with_path(want),
                                jax.tree_util.tree_leaves(tree)):
            np.testing.assert_allclose(a, b, atol=1e-5, rtol=0, err_msg=str(path))
    start = _jax_state().params["vision_proj"]
    assert float(np.abs(ours.params["vision_proj"] - start).max()) > 0


def test_vision_proj_gradient_matches_jax_grad():
    jcfg, cfg = _cfgs()
    batch = _batch(0)
    jm = jax_build_model(jcfg)
    jlayout = JaxLayout(q_chunk=16, kv_chunk=16)

    def jloss(vp):
        params = dict(jax.tree_util.tree_map(jnp.asarray, _jax_state().params), vision_proj=vp)
        x, _ = jm.forward_hidden(params, {k: jnp.asarray(v) for k, v in batch.items()},
                                 jax_steps.run_opts_from_layout(jlayout, None))
        return jax_steps.chunked_cross_entropy(x, jm.unembed_weight(params),
                                               jnp.asarray(batch["labels"]), jlayout.ce_chunk)

    want = np.asarray(jax.grad(jloss)(jnp.asarray(_jax_state().params["vision_proj"])))
    model = build_model(cfg)
    params = params_from_jax(_jax_state().params, cfg, "cpu")
    params["vision_proj"].requires_grad_()
    tb = {k: torch.from_numpy(v) for k, v in batch.items()}
    x, _ = model.forward_hidden(params, tb, RunOpts(attn_impl="flash", q_chunk=16, kv_chunk=16))
    assert tuple(x.shape) == (B, S, cfg.d_model)      # the prefix sliced off
    steps.chunked_cross_entropy(x, model.unembed_weight(params), tb["labels"]).backward()
    got = params["vision_proj"].grad.numpy()
    assert float(np.abs(want).max()) > 1e-4
    np.testing.assert_allclose(got, want, atol=1e-5, rtol=0)


def test_run_segment_and_launcher_refuse_a_vlm():
    _, cfg = _cfgs()
    model = build_model(cfg)
    state = steps.init_train_state(model, torch.Generator().manual_seed(0), "cpu")
    with pytest.raises(NotImplementedError, match="patches"):
        run_segment(model, state, SyntheticLM(cfg.vocab_size, 8, 2, seed=0), "cpu",
                    TrainConfig(), ShardingLayout(), num_steps=1)
    with pytest.raises(SystemExit, match="patches"):
        train_launcher.main(["--arch", VLM, "--device", "cpu", "--steps", "1"])
