"""Hand-written Hopper kernels of the port, each beside its plain PyTorch
version: ``flash_attention`` (prefill, and its backward for training),
``paged_attention`` (engine decode), ``ssm_scan`` (the Mamba recurrence
of hybrid blocks), ``mlstm`` (the chunkwise xLSTM matrix memory) and
``slstm`` (the xLSTM's scalar-memory recurrence, forward and backward).
Sources live in ``repro_torch/csrc``; ``_build`` compiles them at first use.
"""
