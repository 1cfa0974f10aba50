"""Hand-written Hopper kernels of the port, each beside its plain PyTorch
version: ``flash_attention`` (prefill, and its backward for training),
``paged_attention`` (engine decode), ``ssm_scan`` (the Mamba recurrence
of hybrid blocks) and ``mlstm`` (the chunkwise xLSTM matrix memory).
Sources live in ``repro_torch/csrc``; ``_build`` compiles them at first use.
"""
