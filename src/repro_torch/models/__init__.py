"""Model code of the port (the dense / moe decoder and Mamba2 families)."""

from repro_torch.models.zoo import DecoderLM, MambaLM, build_model

__all__ = ["DecoderLM", "MambaLM", "build_model"]
