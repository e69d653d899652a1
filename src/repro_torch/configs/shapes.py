"""Assigned input-shape set (LM-family: seq_len x global_batch).

``train_*`` shapes lower ``train_step``; ``decode_*`` / ``long_*`` lower
``serve_step`` (one new token against a KV cache of ``seq_len``);
``prefill_*`` lowers a forward pass producing the cache.
"""

from __future__ import annotations

import dataclasses
from typing import Tuple

from .registry import ModelConfig

__all__ = ["ShapeSpec", "SHAPES", "applicable_shapes", "skip_reason"]


@dataclasses.dataclass(frozen=True)
class ShapeSpec:
    name: str
    kind: str          # train | prefill | decode
    seq_len: int
    global_batch: int


SHAPES = {
    "train_4k": ShapeSpec("train_4k", "train", 4_096, 256),
    "prefill_32k": ShapeSpec("prefill_32k", "prefill", 32_768, 32),
    "decode_32k": ShapeSpec("decode_32k", "decode", 32_768, 128),
    "long_500k": ShapeSpec("long_500k", "decode", 524_288, 1),
}


def skip_reason(cfg: ModelConfig, shape: ShapeSpec) -> str | None:
    """Return a human-readable skip reason, or None if the cell runs.

    Per assignment: ``long_500k`` needs sub-quadratic attention -- skipped
    for pure full-attention archs; encoder-only archs would skip decode
    shapes (none assigned here are encoder-only).
    """
    if shape.name == "long_500k" and not cfg.is_subquadratic:
        return ("pure full-attention arch: 512k-context decode requires "
                "sub-quadratic attention (assignment-directed skip)")
    return None


def applicable_shapes(cfg: ModelConfig) -> Tuple[ShapeSpec, ...]:
    return tuple(s for s in SHAPES.values() if skip_reason(cfg, s) is None)
