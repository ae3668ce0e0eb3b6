"""Architecture registry of the port: the configurations its serving paths
have been brought up on (qwen3-1.7b for the decoder family, mamba2-2.7b for
the state-cache family).  Pure data."""

from __future__ import annotations

from typing import Dict

from repro_torch.configs import mamba2_2_7b, qwen3_1_7b
from repro_torch.configs.base import ModelConfig

REGISTRY: Dict[str, ModelConfig] = {
    m.CONFIG.name: m.CONFIG for m in (qwen3_1_7b, mamba2_2_7b)
}

ARCH_NAMES = list(REGISTRY)


def get_config(name: str) -> ModelConfig:
    if name not in REGISTRY:
        raise KeyError(f"unknown arch {name!r}; available: {ARCH_NAMES}")
    return REGISTRY[name]


__all__ = ["REGISTRY", "ARCH_NAMES", "ModelConfig", "get_config"]
