"""starcoder2-15b [dense] — StarCoder2 15B (arXiv:2402.19173; hf).

40L d_model=6144 48H (GQA kv=4) d_ff=24576 vocab=49152; RoPE.
"""
from repro_torch.configs.base import ModelConfig

CONFIG = ModelConfig(
    name="starcoder2-15b",
    family="dense",
    n_layers=40,
    d_model=6144,
    n_heads=48,
    n_kv_heads=4,
    head_dim=128,
    d_ff=24576,
    vocab=49152,
    rope_theta=1e5,
)
