"""Event-log serialization (the port's copy of the JSONL half of
``repro.obs.export``): one ``events.as_dict`` object per line.

Python's ``json`` emits shortest-round-trip floats, so a write/read cycle
reconstructs every float bit-exactly, and a log written here replays
through the reference's ``python -m repro.obs.replay``.
"""
from __future__ import annotations

import json
from typing import Iterable, List

from repro_torch.obs import events as ev


def write_jsonl(path, event_seq: Iterable) -> int:
    """Write events as JSONL; returns the number of lines written."""
    n = 0
    with open(path, "w") as fh:
        for event in event_seq:
            fh.write(json.dumps(ev.as_dict(event), separators=(",", ":")))
            fh.write("\n")
            n += 1
    return n


def read_jsonl(path) -> List:
    """Read a JSONL event log back into typed event instances."""
    out: List = []
    with open(path) as fh:
        for line in fh:
            line = line.strip()
            if line:
                out.append(ev.from_dict(json.loads(line)))
    return out
