"""LR schedules: linear warmup + cosine decay (the MoE-training default).

Counterpart of ``src/repro/optim/schedule.py``.  Each schedule is a plain
function of the step that returns a Python float, computed in float32 in
the reference's order of operations, so that both packages feed AdamW the
same rate.
"""

from __future__ import annotations

import numpy as np

__all__ = ["cosine_schedule", "constant_schedule"]


def cosine_schedule(peak_lr: float, warmup_steps: int, total_steps: int,
                    floor_ratio: float = 0.1):
    floor = peak_lr * floor_ratio
    f32 = np.float32

    def lr(step) -> float:
        step = f32(int(step))
        warm = f32(peak_lr) * step / f32(max(warmup_steps, 1))
        frac = np.clip((step - f32(warmup_steps))
                       / f32(max(total_steps - warmup_steps, 1)),
                       f32(0), f32(1))
        cos = f32(floor) + f32(0.5 * (peak_lr - floor)) \
            * (f32(1) + np.cos(f32(np.pi) * frac))
        return float(warm if step < warmup_steps else cos)

    return lr


def constant_schedule(lr_value: float):
    return lambda step: float(np.float32(lr_value))
