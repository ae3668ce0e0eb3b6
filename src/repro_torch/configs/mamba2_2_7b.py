"""mamba2-2.7b [ssm] — Mamba2 2.7B, SSD (arXiv:2405.21060; unverified).

64L d_model=2560, attention-free; ssm_state=128, head_dim 64, expand 2,
conv width 4; vocab=50280.  Sub-quadratic -> runs long_500k.
"""
from repro_torch.configs.base import ModelConfig

CONFIG = ModelConfig(
    name="mamba2-2.7b",
    family="ssm",
    n_layers=64,
    d_model=2560,
    n_heads=0,
    n_kv_heads=0,
    d_ff=0,
    vocab=50280,
    ssm_state=128,
    ssm_head_dim=64,
    ssm_expand=2,
    conv_width=4,
    sub_quadratic=True,
)
