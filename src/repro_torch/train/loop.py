"""Training loop: step + prefetch + watchdog + checkpoint hooks +
revocation signals (port of ``repro.train.loop``).

``run_segment`` executes a bounded slice of steps — the orchestrator's unit
of provisioning. A ``revoke_at_step`` callback injects spot-instance
revocations; the loop raises :class:`Revoked` carrying the last step
completed, so the caller decides what survives. Where the JAX loop takes a
mesh, this one takes the device that the state lives on: each batch is
copied there, and ``float(metrics["loss"])`` is the step's device sync.

On a plan of several ranks (``mesh``: a distributed ``SlotMesh`` from
``repro_torch.launch.mesh``) every rank of the plan runs the loop alike,
each holding its slices of the state by :func:`state_shardings`, and the
step is :func:`~repro_torch.train.steps.build_sharded_train_step`; a
checkpoint gathers the state to one writer. A rank outside the plan walks
the same steps (and the same revocation) without computing.
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
from repro_torch.dist.sharding import SlotMesh, param_shardings, replicated
from repro_torch.models import zoo
from repro_torch.optim import OptState
from repro_torch.train.steps import TrainState, build_sharded_train_step, build_train_step
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


def state_shardings(model: zoo.Model, mesh: SlotMesh, layout: ShardingLayout) -> TrainState:
    """The reference's ``make_jitted_step`` placements: params and both
    moments by the param rules, ``count`` and ``step`` replicated."""
    p_sh = param_shardings(model.specs, mesh, layout)
    repl = replicated(mesh)
    return TrainState(params=p_sh, opt=OptState(m=p_sh, v=p_sh, count=repl), step=repl)


def make_step(model: zoo.Model, tc: TrainConfig, layout: ShardingLayout,
              mesh: Optional[SlotMesh] = None):
    """The counterpart of ``make_jitted_step``, with no jit: on a
    distributed mesh of several ranks the sharded step, else the step on
    one device."""
    if mesh is not None and mesh.distributed and len(mesh.slots) > 1:
        return build_sharded_train_step(model, tc, layout, mesh)
    return build_train_step(model, tc, layout)


def _member(mesh: Optional[SlotMesh]) -> bool:
    if mesh is None or not mesh.distributed:
        return True
    from repro_torch.launch.mesh import world

    return world().rank in mesh.slots


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
    mesh: Optional[SlotMesh] = None,
) -> SegmentResult:
    """``jitted`` keeps the reference's name: a step from :func:`make_step`
    (for ``mesh``, the plan's mesh, where one is given). A rank outside a
    distributed ``mesh`` returns ``state`` as it is, with no losses and no
    times. The data path makes tokens and labels only, so an encoder-decoder
    (whose batches carry ``frames``) and a VLM (whose batches carry
    ``patches``) are refused: train them through ``build_train_step`` with
    their frames or patches, as the reference can."""
    needs = "frames" if model.cfg.encoder_layers else "patches" if model.cfg.vision_tokens else ""
    if needs:
        raise NotImplementedError(
            f"run_segment: {model.cfg.name} needs {needs}, which the data path does not make; "
            f"train it step by step through build_train_step")
    dev = resolve_device(device)
    if not _member(mesh):
        for step in range(start_step, start_step + num_steps):
            if revoke_at_step is not None and revoke_at_step(step):
                raise Revoked(step - 1)
        return SegmentResult(state=state, steps_done=num_steps, losses=[], step_seconds=[],
                             stragglers=[])
    step_fn = jitted if jitted is not None else make_step(model, tc, layout, mesh)
    ckpt_sh = (state_shardings(model, mesh, layout)
               if ckpt is not None and mesh is not None and mesh.distributed else None)
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
                ckpt.save(step + 1, state, shardings=ckpt_sh)
    finally:
        pre.close()
    return SegmentResult(
        state=state,
        steps_done=num_steps,
        losses=losses,
        step_seconds=times,
        stragglers=list(wd.flagged),
    )
