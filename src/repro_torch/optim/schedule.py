"""Learning-rate schedules (pure functions of the step), in float32 as
the reference computes them; they return a Python float."""
from __future__ import annotations

import numpy as np

from repro_torch.config.base import TrainConfig

_F = np.float32


def _parts(step, tc: TrainConfig):
    step = _F(step)
    warm = _F(tc.learning_rate) * min(_F(1.0), step / _F(max(tc.warmup_steps, 1)))
    frac = np.clip(
        (step - _F(tc.warmup_steps)) / _F(max(tc.total_steps - tc.warmup_steps, 1)),
        _F(0.0), _F(1.0),
    )
    return step, _F(warm), _F(frac)


def warmup_cosine(step, tc: TrainConfig) -> float:
    step, warm, frac = _parts(step, tc)
    cos = _F(0.5) * (_F(1.0) + np.cos(_F(np.pi) * frac))
    decayed = _F(tc.learning_rate) * (_F(0.1) + _F(0.9) * cos)
    return float(warm if step < tc.warmup_steps else decayed)


def linear(step, tc: TrainConfig) -> float:
    step, warm, frac = _parts(step, tc)
    return float(warm if step < tc.warmup_steps
                 else _F(tc.learning_rate) * (_F(1.0) - _F(0.9) * frac))


SCHEDULES = {"warmup_cosine": warmup_cosine, "linear": linear}
