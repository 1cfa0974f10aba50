"""Straggler watchdog: EWMA step-time anomaly detector.

At pod scale a single slow host (thermal throttling, failing HBM, noisy
neighbor on the DCN) drags every synchronous step. The watchdog keeps an
exponential moving mean/variance of step latency and flags steps beyond
``mean + k·sigma`` (and a relative floor). On a real deployment the flag
feeds the coordinator (drop-to-quorum or re-slice); here it is fully unit-
tested logic plus a callback hook.
"""
from __future__ import annotations

import dataclasses
import math
from typing import Callable, List, Optional


@dataclasses.dataclass
class StragglerWatchdog:
    alpha: float = 0.1          # EWMA weight for new observations
    k_sigma: float = 4.0        # flag threshold in sigmas
    rel_floor: float = 1.5      # and at least 1.5× the mean
    warmup: int = 5             # steps before flagging starts
    on_straggler: Optional[Callable[[int, float, float], None]] = None

    _mean: float = 0.0
    _var: float = 0.0
    _n: int = 0
    flagged: List[int] = dataclasses.field(default_factory=list)

    def observe(self, step: int, dt: float) -> bool:
        """Record one step latency; returns True when the step is a straggler."""
        self._n += 1
        if self._n == 1:
            self._mean = dt
            self._var = 0.0
            return False
        is_slow = False
        if self._n > self.warmup:
            sigma = math.sqrt(max(self._var, 1e-12))
            is_slow = dt > self._mean + self.k_sigma * sigma and dt > self.rel_floor * self._mean
        if is_slow:
            self.flagged.append(step)
            if self.on_straggler is not None:
                self.on_straggler(step, dt, self._mean)
            return True  # don't poison the EWMA with the anomaly
        d = dt - self._mean
        self._mean += self.alpha * d
        self._var = (1 - self.alpha) * (self._var + self.alpha * d * d)
        return False

    @property
    def mean(self) -> float:
        return self._mean
