"""zamba2-1.2b [hybrid] — Zamba2 1.2B (arXiv:2411.15242; hf).

38 Mamba2 layers, d_model=2048, shared attention block (32H kv=32,
head_dim 64) applied every 6 layers with concat(hidden, embeddings) input;
d_ff=8192 for the shared block MLP; ssm_state=64; vocab=32000.
Sub-quadratic -> runs long_500k.
"""
from repro_torch.configs.base import ModelConfig

CONFIG = ModelConfig(
    name="zamba2-1.2b",
    family="hybrid",
    n_layers=38,
    d_model=2048,
    n_heads=32,
    n_kv_heads=32,
    head_dim=64,
    d_ff=8192,
    vocab=32000,
    ssm_state=64,
    ssm_head_dim=64,
    attn_every=6,
    sub_quadratic=True,
)
