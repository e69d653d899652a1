"""Atomic step-directory checkpoints (``src/repro/checkpoint/``)."""

from .checkpoint import (
    available_steps,
    latest_step,
    restore_checkpoint,
    save_checkpoint,
)

__all__ = ["available_steps", "latest_step", "restore_checkpoint",
           "save_checkpoint"]
