"""Elastic resharding: move live training state onto a plan's slots (port
of ``repro.dist.elastic``).

The reference ``device_put``s every leaf onto its new ``NamedSharding``.
Here a placement names slots of a pool, and a pool may repeat one device:
a leaf moves to the one device the placement's slots name (``.to``, no
copy when it is already there). A placement spanning more than one
distinct device would need collectives, which the port does not have yet:
that raises.
"""
from __future__ import annotations

from typing import Any

import torch

from repro_torch.dist.sharding import Placement
from repro_torch.models.common import tree_flatten


def placement_device(placement: Placement) -> torch.device:
    """The one device a placement's slots name."""
    devices = placement.mesh.distinct_devices
    if len(devices) != 1:
        raise NotImplementedError(
            f"repro_torch: a placement over {len(devices)} distinct devices "
            f"({', '.join(map(str, devices))}) needs multi-device execution, not ported")
    return devices[0]


def _put(x, placement: Placement):
    dev = placement_device(placement)
    return x.to(dev) if isinstance(x, torch.Tensor) else x


def reshard_tree(tree: Any, shardings: Any) -> Any:
    """Move every tensor leaf of ``tree`` to the device of the matching
    placement leaf; other leaves (the step and moment count) pass."""
    leaves, unflatten = tree_flatten(tree)
    placements = tree_flatten(shardings)[0]
    assert len(leaves) == len(placements), (len(leaves), len(placements))
    return unflatten([_put(x, p) for x, p in zip(leaves, placements)])

