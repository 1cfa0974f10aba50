"""``repro_torch`` — the PyTorch/CUDA port of ``repro``, for one NVIDIA H100.

Layout and names follow ``src/repro/`` so each module's counterpart is
easy to find. The port imports ``torch`` and numpy only: never JAX and
nothing of the ``repro`` package, whose JAX-free modules it copies.

Entry points run on ``cuda`` unless the caller passes ``device="cpu"``;
with no GPU present and the CPU not asked for, they raise. On a CUDA
tensor the attention wrappers launch the hand-written Hopper kernels in
``csrc/`` (built by ``kernels/_build.py`` at first use); on a CPU tensor
they run the kernels' plain PyTorch versions.
"""
from __future__ import annotations

import torch


def resolve_device(device) -> torch.device:
    """The device an entry point runs on; raise if CUDA is asked for but
    absent rather than silently running on the CPU."""
    dev = torch.device(device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "repro_torch: CUDA device requested but torch.cuda.is_available() "
            "is False; pass device='cpu' to run the plain versions on the CPU"
        )
    if dev.type not in ("cuda", "cpu", "meta"):   # meta: shapes only, the dry run's
        raise ValueError(f"repro_torch: unsupported device {dev}")
    return dev
