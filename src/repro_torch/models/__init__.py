"""Model code of the port (the dense decoder family in this slice)."""

from repro_torch.models.zoo import DecoderLM

__all__ = ["DecoderLM"]
