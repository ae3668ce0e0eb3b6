"""qwen2-moe-a2.7b [moe] — Qwen1.5-MoE A2.7B (hf:Qwen/Qwen1.5-MoE-A2.7B; hf).

24L d_model=2048 16H (GQA kv=16) expert d_ff=1408 vocab=151936;
60 routed experts top-4 + 4 shared experts.
"""
from repro_torch.configs.base import ModelConfig

CONFIG = ModelConfig(
    name="qwen2-moe-a2.7b",
    family="moe",
    n_layers=24,
    d_model=2048,
    n_heads=16,
    n_kv_heads=16,
    head_dim=128,
    d_ff=1408,
    vocab=151936,
    rope_theta=1e6,
    n_experts=60,
    top_k=4,
    d_expert=1408,
    n_shared_experts=4,
    norm_topk=False,
)
