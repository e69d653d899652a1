"""AdamW and the learning-rate schedules (``src/repro/optim/``)."""

from .adamw import AdamWConfig, OptState, adamw_update, global_norm, \
    init_opt_state
from .schedule import constant_schedule, cosine_schedule

__all__ = [
    "AdamWConfig", "OptState", "adamw_update", "global_norm",
    "init_opt_state", "constant_schedule", "cosine_schedule",
]
