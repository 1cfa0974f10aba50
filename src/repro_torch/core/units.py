"""Named unit-conversion constants — the single home for conversion factors.

Every module that converts between the repo's canonical units imports the
factor from here instead of writing a bare ``3600`` / ``1e9`` / ``2**30``
literal. The ``repro-lint`` units pass (``tools/analysis/units.py``, rule
U002) enforces this: a bare conversion literal in arithmetic under
``src/repro/{core,serve,dist}`` or ``benchmarks/`` is a lint error,
because a mixed-up factor silently invalidates every BENCH_*.json number.

Canonical units, for reference (see docs/accounting.md):

* wall time     — **hours** (``*_hours``); the router works in seconds
  internally (``*_seconds``) and converts at the Breakdown boundary.
* money         — **USD** (``*_usd``); spot prices are ``$/h``.
* state volume  — **bytes** (``*_bytes``); menus quote memory in decimal
  ``*_gb`` and wire bandwidth in ``*_gbps`` (decimal GB/s).
* demand        — **tokens** and ``tokens_per_sec``.

Each constant is exactly the literal it replaces, so swapping them in is
bit-exact — no BENCH column moves.
"""
from __future__ import annotations

# wall time
SECONDS_PER_HOUR = 3600.0
MINUTES_PER_HOUR = 60.0
# int, not float: day counts scale array extents (np.empty((n, n_hours)))
HOURS_PER_DAY = 24

# state volume: decimal GB for bandwidth math (``*_gbps`` quotes GB/s),
# binary GiB for memory-footprint reporting (matches the 16 GiB HBM spec)
BYTES_PER_GB = 1e9
BYTES_PER_GIB = 2**30

# timer / token-volume reporting scales
MICROSECONDS_PER_SECOND = 1e6
TOKENS_PER_MEGATOKEN = 1e6
