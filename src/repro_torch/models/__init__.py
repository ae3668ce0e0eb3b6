"""Model code of the port: the six families (dense, moe and vlm decoders,
Mamba2, the Zamba2 hybrid, the Whisper encoder-decoder)."""

from repro_torch.models.zoo import DecoderLM, EncDecLM, HybridLM, MambaLM, build_model

__all__ = ["DecoderLM", "EncDecLM", "HybridLM", "MambaLM", "build_model"]
