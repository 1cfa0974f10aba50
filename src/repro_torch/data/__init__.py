from repro_torch.data.pipeline import Prefetcher, SyntheticLM

__all__ = ["Prefetcher", "SyntheticLM"]
