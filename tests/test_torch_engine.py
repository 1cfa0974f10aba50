"""The PyTorch port's continuous-batching ``DecodeEngine`` on the CPU.

At f32 its greedy streams must equal a JAX oracle written here: the JAX
package's ``Model.prefill`` per request, packed into the same pool pages,
then ``Model.decode_step_paged`` with the same block tables and
``seq_lens``, under the same FIFO admission. (The JAX ``DecodeEngine``
itself needs a mesh constraint that this JAX version rejects, so it
cannot be the oracle.) The rest mirrors ``tests/test_serve_engine.py`` on
the port alone: drain under page pressure, batched equals solo, shed then
resume, the occupancy / page-pool gauges and lane events, the tracker.
Sizes are the JAX test's.
"""
from collections import deque
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.config import get_arch as jax_get_arch
from repro.dist.meshplan import ThroughputTracker
from repro.models import build_model as jax_build_model
from repro_torch.config import ShardingLayout, get_arch
from repro_torch.dist import ThroughputTracker as PortThroughputTracker
from repro_torch.models import build_model
from repro_torch.models.convert import params_from_jax
from repro_torch.obs import events as E
from repro_torch.obs.recorder import recording
from repro_torch.serve import DecodeEngine, Request

PROMPT_LENS = (5, 17, 9, 30)
NEW = 6
PS = 16


@pytest.fixture(scope="module")
def served():
    """One batched port run under page pressure (f32, plain attention)."""
    jcfg = dataclasses.replace(jax_get_arch("qwen3-4b").reduced(), dtype="float32")
    cfg = dataclasses.replace(get_arch("qwen3-4b").reduced(), dtype="float32")
    jm = jax_build_model(jcfg)
    jp = jm.init(jax.random.key(0))
    model = build_model(cfg)
    params = params_from_jax(jax.tree_util.tree_map(np.asarray, jp), cfg, "cpu")
    rng = np.random.RandomState(0)
    prompts = [rng.randint(0, cfg.vocab_size, n).astype(np.int32) for n in PROMPT_LENS]
    reqs = [Request(rid=i, prompt=p, max_new_tokens=NEW) for i, p in enumerate(prompts)]
    eng = _engine(model, lanes=2, num_pages=7)
    for r in reqs:
        eng.submit(r)
    done = eng.run(params)
    return jm, jp, model, params, reqs, eng, done


def _engine(model, **kw):
    kw.setdefault("max_context", 48)
    return DecodeEngine(model, ShardingLayout(), "cpu", **kw)


def _jax_engine_oracle(jm, jp, reqs, lanes, num_pages, max_context):
    """Greedy streams from the JAX model under the engine's schedule."""
    max_blocks = -(-max_context // PS)
    free = deque(range(num_pages - 1))
    pending = deque(reqs)
    slots = [None] * lanes          # [rid, pages, seq_len, current, generated]
    done = {}
    cache = jm.init_paged_cache(num_pages)
    while pending or any(slots):
        while pending and None in slots:
            r = pending[0]
            pages_needed = -(-(len(r.prompt) + r.max_new_tokens) // PS)
            if pages_needed > len(free):
                break
            pending.popleft()
            pages = [free.popleft() for _ in range(pages_needed)]
            S = len(r.prompt)
            logits, dense = jm.prefill(jp, {"tokens": jnp.asarray(r.prompt[None])}, S)
            n_dense = dense["blocks"]["k"].shape[2] // PS
            for dk, pk in (("k", "k_pages"), ("v", "v_pages")):
                src = dense["blocks"][dk][:, 0]
                L, T = src.shape[:2]
                cache["blocks"][pk] = cache["blocks"][pk].at[:, jnp.asarray(pages[:n_dense])].set(
                    src.reshape(L, T // PS, PS, *src.shape[2:]))
            cur = int(jnp.argmax(logits[0, -1]))
            slots[slots.index(None)] = [r.rid, pages, S, cur, [cur]]
        active = [i for i, s in enumerate(slots) if s is not None]
        tokens = np.zeros((lanes, 1), np.int32)
        seq_lens = np.zeros(lanes, np.int32)
        table = np.full((lanes, max_blocks), -1, np.int32)
        for i in active:
            rid, pages, sl, cur, _ = slots[i]
            tokens[i, 0], seq_lens[i] = cur, sl
            table[i, :len(pages)] = pages
        logits, cache = jm.decode_step_paged(
            jp, cache, jnp.asarray(tokens), jnp.asarray(seq_lens), jnp.asarray(table))
        nxt = np.asarray(jnp.argmax(logits[:, -1], axis=-1))
        for i in active:
            s = slots[i]
            s[2] += 1
            s[3] = int(nxt[i])
            s[4].append(s[3])
            if len(s[4]) >= NEW:
                free.extend(s[1])
                done[s[0]] = s[4]
                slots[i] = None
    return done


def test_engine_streams_equal_jax_oracle_f32(served):
    jm, jp, model, params, reqs, eng, done = served
    oracle = _jax_engine_oracle(jm, jp, reqs, lanes=2, num_pages=7, max_context=48)
    assert {c.rid: c.tokens for c in done} == oracle


def test_engine_serves_all_requests_under_page_pressure(served):
    *_, reqs, eng, done = served
    assert sorted(c.rid for c in done) == [r.rid for r in reqs]
    assert all(len(c.tokens) == NEW and c.reason == "length" for c in done)
    assert eng.in_flight == 0
    assert eng.free_pages == 7 - 1  # every page back, but the trash page
    assert eng.prefills == len(reqs) and eng.decode_steps > 0
    assert eng.measured_tokens_per_sec > 0


def test_engine_batched_matches_solo_streams(served):
    _, _, model, params, reqs, _, done = served
    by_rid = {c.rid: c for c in done}
    for r in reqs[:2]:
        solo = _engine(model, lanes=1, num_pages=4)
        solo.submit(Request(rid=r.rid, prompt=r.prompt, max_new_tokens=NEW))
        (sd,) = solo.run(params)
        assert sd.tokens == by_rid[r.rid].tokens, r.rid


def test_engine_shed_resume_token_identical(served):
    _, _, model, params, reqs, _, done = served
    by_rid = {c.rid: c for c in done}
    eng1 = _engine(model, lanes=2, num_pages=9)
    for r in reqs[:2]:
        eng1.submit(r)
    for _ in range(3):
        eng1.step(params)
    resumed = eng1.shed()
    assert {q.rid for q in resumed} == {0, 1}
    assert all(len(q.resume_tokens) > 0 for q in resumed)
    assert not eng1.completions and eng1.free_pages == 8
    eng2 = _engine(model, lanes=2, num_pages=9)
    for q in resumed:
        eng2.submit(q)
    for c in eng2.run(params):
        assert c.tokens == by_rid[c.rid].tokens, c.rid


def test_engine_gauges_and_lane_events_under_shed(served):
    _, _, model, params, reqs, *_ = served
    with recording() as rec:
        eng = _engine(model, lanes=2, num_pages=9)
        for r in reqs[:2]:
            eng.submit(r)
        for _ in range(3):
            eng.step(params)
        assert eng.occupancy == 1.0 and eng.page_pool_used_frac > 0.0
        occ_before, pool_before = eng.occupancy, eng.page_pool_used_frac
        resumed = eng.shed()
        assert eng.occupancy == 0.0 and eng.page_pool_used_frac == 0.0

    admits = [e for e in rec.events if isinstance(e, E.Admit)]
    sheds = [e for e in rec.events if isinstance(e, E.Shed)]
    evicts = [e for e in rec.events if isinstance(e, E.Evict)]
    assert [e.request_id for e in admits] == [0, 1]
    assert [e.pages_reserved for e in admits] == [
        -(-(len(r.prompt) + NEW) // PS) for r in reqs[:2]]
    assert len(sheds) == 2 and all(e.reason == "shed" for e in evicts) and len(evicts) == 2
    by_rid = {r.rid: r for r in reqs}
    for s in sheds:
        assert s.prompt_tokens == len(by_rid[s.request_id].prompt)
        assert s.resume_tokens == 4   # prefill's token + one per decode step
    assert {q.rid: len(q.resume_tokens) for q in resumed} == {0: 4, 1: 4}
    occ = rec.gauge_series["engine.occupancy"]
    pool = rec.gauge_series["engine.page_pool_used_frac"]
    assert occ[0][1] == 0.5 and (occ[1][1], pool[1][1]) == (occ_before, pool_before)
    assert occ[-1][1] == 0.0 and pool[-1][1] == 0.0


def test_engine_occupancy_tracks_live_lanes(served):
    _, _, model, params, reqs, *_ = served
    eng = _engine(model, lanes=2, num_pages=9)
    assert eng.occupancy == 0.0
    eng.submit(reqs[0])
    eng.step(params)
    assert eng.occupancy == 0.5
    eng.run(params)
    assert eng.occupancy == 0.0


def _feeds(served, tracker):
    _, _, model, params, reqs, *_ = served
    eng = _engine(model, lanes=2, num_pages=9, tracker=tracker, tracker_key="1x1")
    for r in reqs[:2]:
        eng.submit(r)
    eng.run(params)
    assert tracker.steps_per_sec("1x1") > 0.0
    assert eng.measured_tokens_per_sec > 0.0


def test_engine_feeds_duck_typed_tracker(served):
    """The port's own ThroughputTracker (``repro_torch.dist``) is fed by the
    port's engine (duck typing: ``observe(key, steps, seconds)``)."""
    _feeds(served, PortThroughputTracker())


def test_engine_feeds_jax_tracker(served):
    """The JAX package's ThroughputTracker takes the same feed unchanged."""
    _feeds(served, ThroughputTracker())


def test_engine_refuses_what_it_cannot_run(served, monkeypatch):
    """A vision prefix (the paged decode serves text) and a missing card;
    the int8 pool is served (tests/test_torch_int8_cache.py)."""
    _, _, model, *_ = served
    with pytest.raises(NotImplementedError, match="vision"):
        DecodeEngine(build_model(get_arch("internvl2-26b").reduced()), ShardingLayout(),
                     "cpu", lanes=1, num_pages=4, max_context=48)
    eng = DecodeEngine(model, ShardingLayout(int8_kv_cache=True), "cpu",
                       lanes=1, num_pages=4, max_context=48)
    assert eng.cache["blocks"]["k_pages"].dtype == torch.int8
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA"):   # the default device is cuda
        DecodeEngine(model, ShardingLayout(attn_impl="flash"),
                     lanes=1, num_pages=4, max_context=48)
