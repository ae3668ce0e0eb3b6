"""Architecture registry of the port: the ten assigned architectures, in the
reference's order, with their published numbers.

`get_config(name)` returns the exact published ModelConfig;
`input_specs(cfg, shape)` returns the model-input batch of one benchmark
cell as meta tensors (shapes and dtypes, no memory: the reference's
ShapeDtypeStructs); `runnable(cfg, shape)` implements the documented skip
matrix (long_500k -> sub-quadratic archs only).  `models.build_model`
serves all six families: dense, moe and vlm (DecoderLM), ssm (MambaLM),
hybrid (HybridLM), encdec (EncDecLM).
"""

from __future__ import annotations

from typing import Dict, Optional

import torch

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


def input_specs(cfg: ModelConfig, shape: ShapeSpec,
                for_loss: bool = True) -> Dict[str, torch.Tensor]:
    """The model-input batch of one cell as meta tensors (shapes and
    dtypes, nothing allocated), under the reference's keys: int32 `tokens`
    (B, S) (decode: (B, 1)) and, for training with `for_loss`, `labels`;
    the vlm's f32 `vision_embeds` (B, n_vision_tokens, d_model) and the
    encdec's f32 `audio_embeds` (B, enc_seq, d_model) for train and
    prefill."""
    b = shape.global_batch

    def spec(*dims, dtype=torch.int32):
        return torch.empty(dims, dtype=dtype, device="meta")

    if shape.kind == "decode":
        return {"tokens": spec(b, 1)}
    if shape.kind not in ("train", "prefill"):
        raise ValueError(shape.kind)
    batch = {"tokens": spec(b, shape.seq_len)}
    if shape.kind == "train" and for_loss:
        batch["labels"] = spec(b, shape.seq_len)
    if cfg.family == "vlm":
        batch["vision_embeds"] = spec(b, cfg.n_vision_tokens, cfg.d_model,
                                      dtype=torch.float32)
    if cfg.family == "encdec":
        batch["audio_embeds"] = spec(b, cfg.enc_seq, cfg.d_model, dtype=torch.float32)
    return batch


__all__ = [
    "REGISTRY", "ARCH_NAMES", "SHAPES", "ModelConfig", "ShapeSpec",
    "get_config", "input_specs", "runnable",
]
