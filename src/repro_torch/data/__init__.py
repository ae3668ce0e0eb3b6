"""The port's data pipeline (numpy; no device code)."""

from repro_torch.data.pipeline import DataConfig, SyntheticLMData

__all__ = ["DataConfig", "SyntheticLMData"]
