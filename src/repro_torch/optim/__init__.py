"""The port's optimizer: AdamW with the reference's arithmetic, and int8
gradient compression."""

from repro_torch.optim.adamw import (
    AdamWConfig,
    adamw_init,
    adamw_update,
    clip_by_global_norm,
    cosine_schedule,
    global_norm,
)
from repro_torch.optim.compress import (compressed_allgather_mean, int8_compress,
                                        int8_decompress)

__all__ = [
    "AdamWConfig",
    "adamw_init",
    "adamw_update",
    "cosine_schedule",
    "global_norm",
    "clip_by_global_norm",
    "int8_compress",
    "int8_decompress",
    "compressed_allgather_mean",
]
