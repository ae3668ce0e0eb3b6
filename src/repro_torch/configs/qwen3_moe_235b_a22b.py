"""qwen3-moe-235b-a22b [moe] — Qwen3-MoE 235B-A22B (hf:Qwen family; hf).

94L d_model=4096 64H (GQA kv=4) expert d_ff=1536 vocab=151936;
MoE 128 experts top-8, no shared experts; qk_norm.
"""
from repro_torch.configs.base import ModelConfig

CONFIG = ModelConfig(
    name="qwen3-moe-235b-a22b",
    family="moe",
    n_layers=94,
    d_model=4096,
    n_heads=64,
    n_kv_heads=4,
    head_dim=128,
    d_ff=1536,
    vocab=151936,
    rope_theta=1e6,
    qk_norm=True,
    n_experts=128,
    top_k=8,
    d_expert=1536,
    norm_topk=True,
)
