"""Architecture registry of the port: the ten assigned architectures, in the
reference's order, with their published numbers.  Pure data.

`get_config(name)` returns the exact published ModelConfig; `runnable(cfg,
shape)` implements the documented skip matrix (long_500k -> sub-quadratic
archs only).  The families the port serves are dense, moe (DecoderLM) and
ssm (MambaLM); `models.build_model` raises for the rest.
"""

from __future__ import annotations

from typing import Dict, Optional

from repro_torch.configs import (
    granite_3_8b,
    internlm2_20b,
    mamba2_2_7b,
    qwen2_moe_a2_7b,
    qwen2_vl_2b,
    qwen3_1_7b,
    qwen3_moe_235b_a22b,
    starcoder2_15b,
    whisper_base,
    zamba2_1_2b,
)
from repro_torch.configs.base import SHAPES, ModelConfig, ShapeSpec

REGISTRY: Dict[str, ModelConfig] = {
    m.CONFIG.name: m.CONFIG
    for m in (
        qwen2_vl_2b,
        qwen3_1_7b,
        internlm2_20b,
        granite_3_8b,
        starcoder2_15b,
        qwen3_moe_235b_a22b,
        qwen2_moe_a2_7b,
        zamba2_1_2b,
        mamba2_2_7b,
        whisper_base,
    )
}

ARCH_NAMES = list(REGISTRY)


def get_config(name: str) -> ModelConfig:
    if name not in REGISTRY:
        raise KeyError(f"unknown arch {name!r}; available: {ARCH_NAMES}")
    return REGISTRY[name]


def runnable(cfg: ModelConfig, shape: ShapeSpec) -> Optional[str]:
    """None if the (arch, shape) cell runs; else the documented skip reason."""
    if shape.name == "long_500k" and not cfg.sub_quadratic:
        return ("SKIP: pure full-attention arch — 512k-token cache/prefill is "
                "not sub-quadratic (see DESIGN.md §Arch-applicability)")
    return None


__all__ = [
    "REGISTRY", "ARCH_NAMES", "SHAPES", "ModelConfig", "ShapeSpec",
    "get_config", "runnable",
]
