"""The fault-tolerant training loop (``src/repro/runtime/``)."""

from .trainer import Trainer, TrainerConfig

__all__ = ["Trainer", "TrainerConfig"]
