"""The port's fault-tolerant trainer (`python -m repro_torch.train`)."""

from repro_torch.train.trainer import Trainer, TrainerConfig

__all__ = ["Trainer", "TrainerConfig"]
