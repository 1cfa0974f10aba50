"""Hand-written Hopper kernels of the port, each beside its plain PyTorch
version: ``flash_attention`` (prefill) and ``paged_attention`` (decode).
Sources live in ``repro_torch/csrc``; ``_build`` compiles them at first use.
"""
