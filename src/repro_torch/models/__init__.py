"""Model code of the port (the dense decoder and Mamba2 families)."""

from repro_torch.models.zoo import DecoderLM, MambaLM

__all__ = ["DecoderLM", "MambaLM"]
