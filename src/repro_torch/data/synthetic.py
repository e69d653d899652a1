"""Deterministic synthetic LM data pipeline.

Structured so a model can actually learn from it (loss decreases in the
end-to-end examples): each sequence is Zipf-distributed tokens with an
induction pattern -- the second half repeats the first half -- so copying
heads reduce loss quickly.  Determinism contract: batch(step, host) depends
only on (seed, step, host), giving bit-identical restarts after preemption
and host-local sharding without a distributed filesystem.
"""

from __future__ import annotations

import dataclasses
from typing import Dict, Iterator, Optional

import numpy as np

from ..configs.registry import ModelConfig

__all__ = ["DataConfig", "SyntheticLM"]


@dataclasses.dataclass(frozen=True)
class DataConfig:
    vocab: int
    seq_len: int
    global_batch: int
    seed: int = 0
    zipf_a: float = 1.3
    n_hosts: int = 1
    host_id: int = 0


class SyntheticLM:
    """Host-sharded deterministic batch stream."""

    def __init__(self, cfg: DataConfig, model_cfg: Optional[ModelConfig] = None):
        if cfg.global_batch % cfg.n_hosts:
            raise ValueError("global_batch must divide across hosts")
        self.cfg = cfg
        self.model_cfg = model_cfg
        self._host_batch = cfg.global_batch // cfg.n_hosts

    def batch(self, step: int) -> Dict[str, np.ndarray]:
        c = self.cfg
        rng = np.random.default_rng(
            np.random.SeedSequence([c.seed, step, c.host_id]))
        b, s = self._host_batch, c.seq_len
        half = s // 2
        ranks = rng.zipf(c.zipf_a, size=(b, half + 1)).astype(np.int64)
        toks = np.minimum(ranks, c.vocab - 1).astype(np.int32)
        seq = np.concatenate([toks[:, :half], toks[:, :s - half]], axis=1)
        labels = np.concatenate(
            [seq[:, 1:], toks[:, s - half:s - half + 1]], axis=1)
        out = {"tokens": seq, "labels": labels.astype(np.int32)}
        mc = self.model_cfg
        if mc is not None and mc.frontend == "vision_stub":
            out["patch_embeds"] = rng.standard_normal(
                (b, mc.frontend_len, mc.d_model)).astype(np.float32) * 0.02
        if mc is not None and mc.frontend == "audio_stub":
            out["frames"] = rng.standard_normal(
                (b, mc.encoder_len, mc.d_model)).astype(np.float32) * 0.02
        return out

    def __iter__(self) -> Iterator[Dict[str, np.ndarray]]:
        step = 0
        while True:
            yield self.batch(step)
            step += 1
