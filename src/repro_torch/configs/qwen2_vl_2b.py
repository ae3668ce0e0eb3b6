"""qwen2-vl-2b [vlm] — Qwen2-VL 2B backbone (arXiv:2409.12191; hf).

28L d_model=1536 12H (GQA kv=2) d_ff=8960 vocab=151936; M-RoPE with
(t, h, w) sections (16, 24, 24) over head_dim 128; dynamic-resolution vision
frontend is a STUB — `input_specs` provides 256 pre-computed patch
embeddings prepended to the sequence.
"""
from repro_torch.configs.base import ModelConfig

CONFIG = ModelConfig(
    name="qwen2-vl-2b",
    family="vlm",
    n_layers=28,
    d_model=1536,
    n_heads=12,
    n_kv_heads=2,
    head_dim=128,
    d_ff=8960,
    vocab=151936,
    rope_theta=1e6,
    mrope_sections=(16, 24, 24),
    n_vision_tokens=256,
)
