"""The port's checkpointing (the JAX package's on-disk format)."""

from repro_torch.checkpoint.manager import CheckpointManager, latest_step

__all__ = ["CheckpointManager", "latest_step"]
