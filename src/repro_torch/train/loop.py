"""Training loop: step + prefetch + watchdog + checkpoint hooks +
revocation signals (port of ``repro.train.loop``).

``run_segment`` executes a bounded slice of steps — the orchestrator's unit
of provisioning. A ``revoke_at_step`` callback injects spot-instance
revocations; the loop raises :class:`Revoked` carrying the last step
completed, so the caller decides what survives. Where the JAX loop takes a
mesh, this one takes the device that the state lives on: each batch is
copied there, and ``float(metrics["loss"])`` is the step's device sync.
"""
from __future__ import annotations

import dataclasses
import time
from typing import Callable, Dict, List, Optional

import numpy as np
import torch

from repro_torch import resolve_device
from repro_torch.ckpt import CheckpointManager
from repro_torch.config.base import ShardingLayout, TrainConfig
from repro_torch.data import Prefetcher, SyntheticLM
from repro_torch.models import zoo
from repro_torch.train.steps import TrainState, build_train_step
from repro_torch.train.watchdog import StragglerWatchdog


class Revoked(Exception):
    def __init__(self, last_step: int):
        super().__init__(f"spot instance revoked after step {last_step}")
        self.last_step = last_step


@dataclasses.dataclass
class SegmentResult:
    state: TrainState
    steps_done: int
    losses: List[float]
    step_seconds: List[float]
    stragglers: List[int]


def make_step(model: zoo.Model, tc: TrainConfig, layout: ShardingLayout):
    """The counterpart of ``make_jitted_step``: one device, no mesh, no jit."""
    return build_train_step(model, tc, layout)


def _to_device(batch: Dict[str, np.ndarray], device: torch.device) -> Dict[str, torch.Tensor]:
    return {k: torch.from_numpy(v).to(device) for k, v in batch.items()}


def run_segment(
    model: zoo.Model,
    state: TrainState,
    dataset: SyntheticLM,
    device,
    tc: TrainConfig,
    layout: ShardingLayout,
    *,
    num_steps: int,
    start_step: int = 0,
    ckpt: Optional[CheckpointManager] = None,
    ckpt_every: int = 0,
    revoke_at_step: Optional[Callable[[int], bool]] = None,
    watchdog: Optional[StragglerWatchdog] = None,
    jitted=None,
) -> SegmentResult:
    """``jitted`` keeps the reference's name: a step from :func:`make_step`.
    The data path makes tokens and labels only, so an encoder-decoder
    (whose batches carry ``frames``) and a VLM (whose batches carry
    ``patches``) are refused: train them through ``build_train_step`` with
    their frames or patches, as the reference can."""
    needs = "frames" if model.cfg.encoder_layers else "patches" if model.cfg.vision_tokens else ""
    if needs:
        raise NotImplementedError(
            f"run_segment: {model.cfg.name} needs {needs}, which the data path does not make; "
            f"train it step by step through build_train_step")
    dev = resolve_device(device)
    step_fn = jitted if jitted is not None else make_step(model, tc, layout)
    wd = watchdog or StragglerWatchdog()
    losses: List[float] = []
    times: List[float] = []
    pre = Prefetcher(dataset, start_step=start_step)
    try:
        for i in range(num_steps):
            step = start_step + i
            if revoke_at_step is not None and revoke_at_step(step):
                raise Revoked(step - 1)
            batch = pre.next()
            t0 = time.perf_counter()
            state, metrics = step_fn(state, _to_device(batch, dev))
            loss = float(metrics["loss"])  # blocks; = device sync
            dt = time.perf_counter() - t0
            losses.append(loss)
            times.append(dt)
            wd.observe(step, dt)
            if ckpt is not None and ckpt_every and (step + 1) % ckpt_every == 0:
                ckpt.save(step + 1, state)
    finally:
        pre.close()
    return SegmentResult(
        state=state,
        steps_done=num_steps,
        losses=losses,
        step_seconds=times,
        stragglers=list(wd.flagged),
    )
