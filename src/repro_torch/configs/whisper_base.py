"""whisper-base [audio] — Whisper base (arXiv:2212.04356; unverified).

6 encoder + 6 decoder layers, d_model=512 8H (kv=8) d_ff=2048 vocab=51865;
enc-dec with layer-norm + GELU; conv audio frontend is a STUB —
`input_specs` provides 1500 pre-computed frame embeddings.
"""
from repro_torch.configs.base import ModelConfig

CONFIG = ModelConfig(
    name="whisper-base",
    family="encdec",
    n_layers=6,
    d_model=512,
    n_heads=8,
    n_kv_heads=8,
    head_dim=64,
    d_ff=2048,
    vocab=51865,
    norm="layer",
    act="gelu",
    n_enc_layers=6,
    enc_seq=1500,
)
