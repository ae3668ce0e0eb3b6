"""Model/architecture configuration (a copy of `ModelConfig` from
`repro.configs.base`, pure data).

One `ModelConfig` instance fully determines a model; an architecture's
module exports `CONFIG` with its published numbers, and tests use
`reduced()` versions of the same family.
"""

from __future__ import annotations

import dataclasses
from typing import Dict, Tuple


@dataclasses.dataclass(frozen=True)
class ModelConfig:
    name: str
    family: str                      # dense | moe | ssm | hybrid | encdec | vlm
    n_layers: int
    d_model: int
    n_heads: int
    n_kv_heads: int
    d_ff: int
    vocab: int
    head_dim: int = 0                # 0 -> d_model // n_heads
    qk_norm: bool = False
    rope_theta: float = 1e4
    mrope_sections: Tuple[int, ...] = ()   # vlm: (t, h, w) pairs, sum = head_dim/2
    norm: str = "rms"                # rms | layer
    act: str = "silu"
    # MoE
    n_experts: int = 0
    top_k: int = 0
    d_expert: int = 0
    n_shared_experts: int = 0
    norm_topk: bool = True
    capacity_factor: float = 1.25
    # SSM (mamba2)
    ssm_state: int = 0
    ssm_head_dim: int = 64
    ssm_expand: int = 2
    conv_width: int = 4
    ssm_chunk: int = 256
    # hybrid (zamba2): one shared attention block applied every `attn_every`
    attn_every: int = 0
    # encoder-decoder (whisper): encoder layer count + stub frontend length
    n_enc_layers: int = 0
    enc_seq: int = 0
    # vlm (qwen2-vl): stub patch embeddings prepended to the sequence
    n_vision_tokens: int = 0
    # compute policy
    dtype: str = "bfloat16"
    remat: str = "none"              # none | dots | full
    sub_quadratic: bool = False      # may run long_500k

    @property
    def hd(self) -> int:
        return self.head_dim or (self.d_model // self.n_heads)

    @property
    def q_per_kv(self) -> int:
        return self.n_heads // max(1, self.n_kv_heads)

    def reduced(self, **overrides) -> "ModelConfig":
        """Same family, laptop scale — used by the per-arch smoke tests."""
        small: Dict = dict(
            n_layers=min(self.n_layers, 2 if self.family != "hybrid" else 4),
            d_model=128,
            n_heads=4,
            n_kv_heads=min(self.n_kv_heads, 2) or 2,
            head_dim=32,
            d_ff=256,
            vocab=512,
        )
        if self.n_experts:
            small.update(n_experts=8, top_k=min(self.top_k, 2), d_expert=64)
        if self.ssm_state:
            small.update(ssm_state=16, ssm_head_dim=16, ssm_chunk=16)
        if self.attn_every:
            small.update(attn_every=2)
        if self.n_enc_layers:
            small.update(n_enc_layers=2, enc_seq=32)
        if self.n_vision_tokens:
            small.update(n_vision_tokens=8)
        if self.mrope_sections:
            small.update(mrope_sections=(4, 6, 6))  # head_dim 32 -> 16 pairs
        small.update(overrides)
        return dataclasses.replace(self, **small)

    def param_count(self) -> int:
        """Approximate parameter count (embeddings + blocks), used for the
        MODEL_FLOPS = 6·N·D roofline term."""
        d, L = self.d_model, self.n_layers
        emb = self.vocab * d * 2  # in + out (untied)
        if self.family == "ssm":
            d_in = self.ssm_expand * d
            nh = d_in // self.ssm_head_dim
            conv_dim = d_in + 2 * self.ssm_state
            per = (d * (2 * d_in + 2 * self.ssm_state + nh)  # in_proj
                   + self.conv_width * conv_dim + 3 * nh + d_in + d_in * d)
            return emb + L * per
        attn = d * (self.n_heads * self.hd) + 2 * d * (self.n_kv_heads * self.hd) \
            + (self.n_heads * self.hd) * d
        if self.family in ("dense", "vlm"):
            return emb + L * (attn + 3 * d * self.d_ff)
        if self.family == "moe":
            route = d * self.n_experts
            experts = self.n_experts * 3 * d * self.d_expert
            shared = self.n_shared_experts * 3 * d * self.d_expert
            return emb + L * (attn + route + experts + shared)
        if self.family == "hybrid":
            d_in = self.ssm_expand * d
            nh = d_in // self.ssm_head_dim
            conv_dim = d_in + 2 * self.ssm_state
            mamba = (d * (2 * d_in + 2 * self.ssm_state + nh)
                     + self.conv_width * conv_dim + 3 * nh + d_in + d_in * d)
            return emb + L * mamba + (attn + 3 * d * self.d_ff + 2 * d * d)
        if self.family == "encdec":
            enc = self.n_enc_layers * (attn + 2 * d * self.d_ff)
            dec = L * (2 * attn + 2 * d * self.d_ff)
            return emb + enc + dec
        raise ValueError(self.family)

    def active_param_count(self) -> int:
        """Active params per token (MoE: routed top-k + shared only)."""
        if self.family != "moe":
            return self.param_count()
        d, L = self.d_model, self.n_layers
        emb = self.vocab * d * 2
        attn = d * (self.n_heads * self.hd) + 2 * d * (self.n_kv_heads * self.hd) \
            + (self.n_heads * self.hd) * d
        active = (self.top_k + self.n_shared_experts) * 3 * d * self.d_expert
        return emb + L * (attn + d * self.n_experts + active)


@dataclasses.dataclass(frozen=True)
class ShapeSpec:
    """One benchmark cell: (kind, seq_len, global_batch)."""

    name: str
    kind: str        # train | prefill | decode
    seq_len: int
    global_batch: int


SHAPES: Dict[str, ShapeSpec] = {
    "train_4k": ShapeSpec("train_4k", "train", 4_096, 256),
    "prefill_32k": ShapeSpec("prefill_32k", "prefill", 32_768, 32),
    "decode_32k": ShapeSpec("decode_32k", "decode", 32_768, 128),
    "long_500k": ShapeSpec("long_500k", "decode", 524_288, 1),
}
