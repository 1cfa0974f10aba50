"""Serving of the port: the continuous-batching decode engine."""
from repro_torch.serve.engine import Completion, DecodeEngine, Request

__all__ = ["Completion", "DecodeEngine", "Request"]
