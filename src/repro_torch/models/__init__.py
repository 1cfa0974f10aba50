"""Model code of the port: the dense, hybrid (Hymba) and xLSTM decoders
behind ``build_model``."""
from repro_torch.models.transformer import RunOpts
from repro_torch.models.zoo import Model, build_model

__all__ = ["Model", "RunOpts", "build_model"]
