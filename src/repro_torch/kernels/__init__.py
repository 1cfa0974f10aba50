"""Hand-written Hopper kernels of the port, each beside its plain PyTorch
version: ``flash_attention`` (prefill, and its backward for training),
``paged_attention`` (engine decode), ``ssm_scan`` (the Mamba recurrence
of hybrid blocks), ``mlstm`` (the chunkwise xLSTM matrix memory) and
``slstm`` (the xLSTM's scalar-memory recurrence, forward and backward).
Sources live in ``repro_torch/csrc``; ``_build`` compiles them at first use.

Each ``ops.py`` routes by device (``on_card``): a CUDA tensor launches the
kernels, a meta tensor takes the same route and allocates the same
tensors but launches nothing (the dry run, ``launch/dryrun.py``, counts
each call by the cost function beside it), a CPU tensor runs the plain
version.
"""
import torch


def on_card(t: torch.Tensor, what: str) -> bool:
    """True where ``t`` takes the kernels' route (cuda, meta), False where
    it takes the plain version (cpu); any other device raises."""
    if t.device.type in ("cuda", "meta"):
        return True
    if t.device.type == "cpu":
        return False
    raise ValueError(f"{what}: unsupported device {t.device}")


def live_pairs(Sq: int, Skv: int, causal: bool, window: int, q_offset: int) -> int:
    """The (q, k) pairs attention computes: every pair without ``causal``;
    with it, query i (at position q_offset + i) sees keys 0 .. its position,
    and only the last ``window`` of them when that is set."""
    if not causal:
        return Sq * Skv

    def below(n: int, c: int) -> int:       # sum of min(x, c) for x = 1 .. n
        return n * (n + 1) // 2 if n <= c else c * (c + 1) // 2 + (n - c) * c

    cap = min(Skv, window) if window else Skv
    return below(q_offset + Sq, cap) - below(q_offset, cap)
