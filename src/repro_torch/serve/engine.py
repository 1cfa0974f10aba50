"""Continuous-batching decode engine over the paged KV pool (port of
``repro.serve.engine``).

A fixed set of decode *lanes* advances every active sequence one token
per step, while a host-side free-page list admits pending requests into
lanes as pool pages free up: insertion at prefill completion, eviction at
EOS / length / shed. Lanes hold sequences of different lengths: each
lane's write position and attention extent come from its own ``seq_lens``
entry, and its pages from its row of the block table.

Admission is FIFO; a request is admitted only when a lane is free AND the
pool has ``ceil((prompt + max_new) / page_size)`` free pages for its whole
lifetime, reserved up front, so an admitted request never stalls on pool
exhaustion. A resumed request's committed tokens are part of its
``max_new_tokens`` (the stream ends when it holds that many), so they add
no pages: the reference adds them again, which over-reserves and refuses a
resumed request that the pool sized for the original one could hold. The pool's LAST page is the trash page: dead
lanes write there and it is never allocated.

Prefill runs dense, one request at a time at its exact prompt length;
the dense cache's ``T // page_size`` pages are then copied into the
request's reserved pool pages. On a CUDA device prefill attention is the
flash kernel (``layout.attn_impl`` must be ``"flash"``) and decode
attention the paged kernel; no argument turns them off there.
"""
from __future__ import annotations

import dataclasses
import time
from collections import deque
from typing import Any, List, Optional

import numpy as np
import torch

from repro_torch import resolve_device
from repro_torch.models.layers import PAGE_SIZE
from repro_torch.obs import events as obs_ev
from repro_torch.obs.recorder import current as obs_current
from repro_torch.train.steps import build_paged_decode_step, build_prefill_step


@dataclasses.dataclass
class Request:
    """One generation request. ``resume_tokens`` carries tokens already
    generated (and committed) before a migration; the engine re-prefills
    prompt + resume_tokens[:-1] and continues from resume_tokens[-1]."""

    rid: int
    prompt: np.ndarray                      # (S,) int32
    max_new_tokens: int
    resume_tokens: Optional[np.ndarray] = None


@dataclasses.dataclass
class Completion:
    rid: int
    tokens: List[int]                       # all generated tokens, in order
    reason: str                             # "eos" | "length" | "shed"


@dataclasses.dataclass
class _Lane:
    rid: int
    prompt: np.ndarray
    max_new_tokens: int
    pages: List[int]                        # reserved pool pages, in order
    seq_len: int                            # tokens written to the pool
    current: int                            # last generated, not yet fed
    generated: List[int]


class DecodeEngine:
    """Continuous-batching greedy decode over a paged KV pool.

    ``device`` defaults to ``"cuda"``; pass ``"cpu"`` to run the plain
    attention versions (tests). ``tracker`` is duck-typed: anything with
    ``observe(key, steps, seconds)``.
    """

    def __init__(
        self,
        model,
        layout,
        device="cuda",
        *,
        lanes: int,
        num_pages: int,
        max_context: int,
        page_size: int = PAGE_SIZE,
        eos_id: Optional[int] = None,
        tracker=None,
        tracker_key: Any = None,
    ):
        if num_pages < 2:
            raise ValueError("pool needs at least one real page + trash")
        if layout.int8_kv_cache:
            raise NotImplementedError("repro_torch: the int8 KV cache is not ported yet")
        self.device = resolve_device(device)
        if self.device.type == "cuda" and layout.attn_impl != "flash":
            raise ValueError(
                f"DecodeEngine on CUDA prefills with the flash kernel: "
                f"layout.attn_impl must be 'flash', got {layout.attn_impl!r}"
            )
        self.model = model
        self.layout = layout
        self.lanes = lanes
        self.page_size = page_size
        self.num_pages = num_pages
        self.max_blocks = -(-max_context // page_size)
        self.eos_id = eos_id
        self.tracker = tracker
        self.tracker_key = tracker_key
        self.decoded_tokens = 0
        self.decode_seconds = 0.0
        self.decode_steps = 0               # decode batches run
        self.prefilled_tokens = 0
        self.prefills = 0
        self.prefill_seconds = 0.0
        self.steps = 0                      # lane-event trace clock

        self._free_pages = deque(range(num_pages - 1))  # last page = trash
        self._pending: deque = deque()
        self._lanes: List[Optional[_Lane]] = [None] * lanes
        self._done: List[Completion] = []
        # the ops wrappers run the kernel on a CUDA tensor, the plain version on the CPU
        self._decode = build_paged_decode_step(model, layout)
        self.cache = model.init_paged_cache(num_pages, self.device, page_size)

    # -- submission ---------------------------------------------------------

    def submit(self, req: Request) -> None:
        self._pending.append(req)

    @property
    def in_flight(self) -> int:
        return len(self._pending) + sum(l is not None for l in self._lanes)

    @property
    def free_pages(self) -> int:
        return len(self._free_pages)

    @property
    def completions(self) -> List[Completion]:
        return list(self._done)

    @property
    def occupancy(self) -> float:
        """Fraction of decode lanes holding a live stream (pending requests
        hold no lane, so they do not count)."""
        if not self._lanes:
            return 0.0
        return sum(l is not None for l in self._lanes) / len(self._lanes)

    @property
    def page_pool_used_frac(self) -> float:
        """Fraction of allocatable pool pages reserved by live lanes (the
        trash page is never allocatable, so a drained engine reads 0.0)."""
        return 1.0 - len(self._free_pages) / (self.num_pages - 1)

    def _sample_gauges(self, rec) -> None:
        t = float(self.steps)
        rec.gauge("engine.occupancy", t, self.occupancy)
        rec.gauge("engine.page_pool_used_frac", t, self.page_pool_used_frac)

    @property
    def measured_tokens_per_sec(self) -> float:
        if self.decode_seconds <= 0:
            return 0.0
        return self.decoded_tokens / self.decode_seconds

    def _sync(self) -> None:
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)

    def release_pool(self) -> None:
        """Free the paged KV pool: the instance is gone and its pages die
        with it. The engine can still ``shed`` its streams, not step."""
        self.cache = None

    # -- admission ----------------------------------------------------------

    def _pages_needed(self, req: Request) -> int:
        return -(-(len(req.prompt) + req.max_new_tokens) // self.page_size)

    def _admit(self) -> None:
        while self._pending and None in self._lanes:
            req = self._pending[0]
            needed = self._pages_needed(req)
            if needed > self.max_blocks:
                raise ValueError(
                    f"request {req.rid} needs {needed} pages > max_blocks {self.max_blocks}"
                )
            if needed > len(self._free_pages):
                return  # FIFO back-pressure: head-of-line waits for pages
            self._pending.popleft()
            self._insert(req, [self._free_pages.popleft() for _ in range(needed)])

    def _pack(self, dense_blocks, pages: List[int]) -> None:
        """Copy the dense prefill cache's pages into the reserved pool pages."""
        ps = self.page_size
        idx = torch.as_tensor(pages, dtype=torch.long, device=self.device)
        for dk, pk in (("k", "k_pages"), ("v", "v_pages")):
            src = dense_blocks[dk][:, 0]                     # (L, T, KVH, hd)
            L, T = src.shape[:2]
            pool = self.cache["blocks"][pk]
            pool[:, idx] = src.reshape(L, T // ps, ps, *src.shape[2:]).to(pool.dtype)

    def _insert(self, req: Request, pages: List[int]) -> None:
        resume = (np.asarray(req.resume_tokens, np.int32)
                  if req.resume_tokens is not None else np.zeros(0, np.int32))
        # the cache holds prompt + all resumed tokens but the newest, which
        # rides the next decode step
        cached = np.concatenate([np.asarray(req.prompt, np.int32), resume[:-1]])
        length = len(cached)
        prefill = build_prefill_step(self.model, self.layout, length)
        tokens = torch.as_tensor(cached[None, :], device=self.device)
        t0 = time.perf_counter()
        logits, dense = prefill(self._params, {"tokens": tokens})
        n_dense = dense["blocks"]["k"].shape[2] // self.page_size
        self._pack(dense["blocks"], pages[:n_dense])
        current = int(resume[-1]) if len(resume) else int(torch.argmax(logits[0, -1]))
        self._sync()
        self.prefill_seconds += time.perf_counter() - t0
        self.prefilled_tokens += length
        self.prefills += 1
        lane = self._lanes.index(None)
        generated = [int(t) for t in resume] if len(resume) else [current]
        self._lanes[lane] = _Lane(
            rid=req.rid, prompt=req.prompt, max_new_tokens=req.max_new_tokens,
            pages=pages, seq_len=length, current=current, generated=generated,
        )
        rec = obs_current()
        if rec.enabled:
            rec.emit(obs_ev.Admit(
                t=float(self.steps), request_id=int(req.rid),
                lane=lane, pages_reserved=len(pages),
            ))
            self._sample_gauges(rec)
        self._maybe_finish(lane)

    # -- stepping -----------------------------------------------------------

    def _maybe_finish(self, lane_idx: int) -> None:
        lane = self._lanes[lane_idx]
        reason = None
        if len(lane.generated) >= lane.max_new_tokens:
            reason = "length"
        elif self.eos_id is not None and lane.generated[-1] == self.eos_id:
            reason = "eos"
        if reason is not None:
            self._evict(lane_idx, reason)

    def _evict(self, lane_idx: int, reason: str) -> None:
        lane = self._lanes[lane_idx]
        self._free_pages.extend(lane.pages)
        self._done.append(Completion(lane.rid, lane.generated, reason))
        self._lanes[lane_idx] = None
        rec = obs_current()
        if rec.enabled:
            rec.emit(obs_ev.Evict(
                t=float(self.steps), request_id=int(lane.rid), lane=lane_idx, reason=reason,
            ))
            self._sample_gauges(rec)

    def shed(self) -> List[Request]:
        """Evict every active lane and drain the queue (spot revocation):
        returns the resumable requests, committed tokens included."""
        rec = obs_current()
        out: List[Request] = []
        for i, lane in enumerate(self._lanes):
            if lane is None:
                continue
            if rec.enabled:
                rec.emit(obs_ev.Shed(
                    t=float(self.steps), request_id=int(lane.rid), lane=i,
                    prompt_tokens=len(lane.prompt), resume_tokens=len(lane.generated),
                ))
            out.append(Request(
                rid=lane.rid, prompt=lane.prompt, max_new_tokens=lane.max_new_tokens,
                resume_tokens=np.asarray(lane.generated, np.int32),
            ))
            self._evict(i, "shed")
            self._done.pop()  # shed lanes resume elsewhere, not completions
        while self._pending:
            out.append(self._pending.popleft())
        return out

    def step(self, params) -> List[Completion]:
        """Admit what fits, advance every active lane one token. Returns
        completions finished by this call."""
        self._params = params
        self.steps += 1
        done_before = len(self._done)
        self._admit()
        active = [i for i, l in enumerate(self._lanes) if l is not None]
        if not active:
            return self._done[done_before:]

        tokens = np.zeros((self.lanes, 1), np.int32)
        seq_lens = np.zeros(self.lanes, np.int32)
        table = np.full((self.lanes, self.max_blocks), -1, np.int32)
        for i in active:
            lane = self._lanes[i]
            tokens[i, 0] = lane.current
            seq_lens[i] = lane.seq_len
            table[i, : len(lane.pages)] = lane.pages

        tok_d = torch.as_tensor(tokens, device=self.device)
        sl_d = torch.as_tensor(seq_lens, device=self.device)
        bt_d = torch.as_tensor(table, device=self.device)
        self._sync()
        t0 = time.perf_counter()
        logits, self.cache = self._decode(params, self.cache, tok_d, sl_d, bt_d)
        nxt = torch.argmax(logits[:, -1], dim=-1)
        self._sync()
        dt = time.perf_counter() - t0
        nxt = nxt.cpu().numpy()
        self.decode_seconds += dt
        self.decoded_tokens += len(active)
        self.decode_steps += 1
        if self.tracker is not None:
            self.tracker.observe(self.tracker_key, 1, dt)

        for i in active:
            lane = self._lanes[i]
            lane.seq_len += 1
            lane.current = int(nxt[i])
            lane.generated.append(lane.current)
            self._maybe_finish(i)
        return self._done[done_before:]

    def run(self, params, max_steps: int = 100_000) -> List[Completion]:
        """Drive until every submitted request completes."""
        for _ in range(max_steps):
            if self.in_flight == 0:
                break
            self.step(params)
        if self.in_flight:
            raise RuntimeError("engine did not drain (pool too small?)")
        return list(self._done)
