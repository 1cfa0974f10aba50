"""Model code of the port: the dense, MoE, hybrid (Hymba) and xLSTM
decoders and the encoder-decoder (whisper) behind ``build_model``."""
from repro_torch.models.transformer import RunOpts
from repro_torch.models.zoo import Model, build_model

__all__ = ["Model", "RunOpts", "build_model"]
