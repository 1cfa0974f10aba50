"""Decode-engine lane events: the port's copy of the ``Admit`` / ``Evict``
/ ``Shed`` types of ``repro.obs.events`` (same fields, same wire names).

Each event is a frozen dataclass of plain data whose first field ``t`` is
the engine's step index.
"""
from __future__ import annotations

from dataclasses import dataclass


@dataclass(frozen=True)
class Admit:
    t: float
    request_id: int
    lane: int
    pages_reserved: int


@dataclass(frozen=True)
class Evict:
    t: float
    request_id: int
    lane: int
    reason: str  # "eos" | "length" | "shed"


@dataclass(frozen=True)
class Shed:
    """Carries everything needed to re-prefill the request elsewhere."""

    t: float
    request_id: int
    lane: int
    prompt_tokens: int
    resume_tokens: int  # tokens generated before the shed
