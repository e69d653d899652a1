"""Fault-tolerant training runtime.

Counterpart of ``src/repro/runtime/trainer.py``: the loop around a train
step, with

  * auto-resume: restores the newest committed checkpoint on start, so a
    preempted job relaunches and continues (the data pipeline is
    (seed, step)-deterministic);
  * preemption handling: SIGTERM/SIGINT trigger a checkpoint at the next
    step boundary before exit;
  * a straggler watchdog: per-step wall times against a rolling median;
    steps slower than ``straggler_factor`` x the median go to a callback;
  * a metrics JSONL log.

The step updates the state in place (``launch/train.py``), so ``init_state``
must build a fresh state on every call.  ``torch.cuda.synchronize`` on the
state's device takes the place of ``block_until_ready`` before a step's
time is read.

On a ``ProcessMesh`` (``mesh``, with the parameters' ``specs``) every
process runs the loop on its shard of the state: the processes agree on the
resume step (rank 0 reads it once every process has arrived and sends it to
all), a preemption any process sees stops all of them at the same step
boundary (each step ends with an any-reduce of the flag), checkpoints are
written whole by rank 0 (``checkpoint.save_checkpoint``), only rank 0 logs,
and each process watches its own step times for stragglers.
"""

from __future__ import annotations

import contextlib
import dataclasses
import json
import os
import signal
import statistics
import time
from typing import Any, Callable, Dict, Optional

import torch

from ..checkpoint import latest_step, restore_checkpoint, save_checkpoint

__all__ = ["TrainerConfig", "Trainer"]


@dataclasses.dataclass
class TrainerConfig:
    total_steps: int
    ckpt_dir: str
    ckpt_every: int = 200
    keep_last: int = 3
    log_every: int = 10
    straggler_factor: float = 3.0
    straggler_window: int = 32


def _device_of(state: Any) -> Optional[torch.device]:
    """The device of the state's parameters."""
    params = state.get("params") if isinstance(state, dict) else None
    if isinstance(params, torch.nn.Module):
        for p in params.parameters():
            return p.device
    return None


class Trainer:
    def __init__(
        self,
        cfg: TrainerConfig,
        train_step: Callable,            # (state, batch) -> (state, metrics)
        init_state: Callable[[], Any],   # a fresh state on every call
        batches: Callable[[int], Dict],  # step -> host batch
        straggler_cb: Optional[Callable[[int, float, float], None]] = None,
        mesh=None,                       # a ProcessMesh: state is a shard
        specs: Optional[Dict[str, tuple]] = None,
    ):
        from ..launch.mesh import ProcessMesh

        self.cfg = cfg
        self.mesh = mesh if isinstance(mesh, ProcessMesh) else None
        self.specs = specs
        self.train_step = train_step
        self.init_state = init_state
        self.batches = batches
        self.straggler_cb = straggler_cb or self._default_straggler_cb
        self._preempted = False
        self._step_times: list = []
        self._straggler_events: list = []

    # -- fault tolerance ---------------------------------------------------

    def _install_signal_handlers(self):
        def handler(signum, frame):
            self._preempted = True
        for sig in (signal.SIGTERM, signal.SIGINT):
            try:
                signal.signal(sig, handler)
            except ValueError:
                pass  # non-main thread (tests)

    def _resume_step(self) -> Optional[int]:
        """The newest committed step, as rank 0 reads it once every process
        has arrived (on a process mesh, sent to all)."""
        if self.mesh is None:
            return latest_step(self.cfg.ckpt_dir)
        from ..launch.mesh import all_ranks

        all_ranks(self.mesh, 0)
        step = latest_step(self.cfg.ckpt_dir) if self.mesh.rank == 0 else None
        step = all_ranks(self.mesh, -1 if step is None else step)[0]
        return None if step < 0 else step

    def _resume_or_init(self):
        state = self.init_state()
        start = self._resume_step()
        if start is None:
            return state, 0
        return restore_checkpoint(self.cfg.ckpt_dir, state, start, self.mesh,
                                  self.specs)

    def _any_preempted(self) -> bool:
        """Whether any process has seen a preemption signal."""
        if self.mesh is None:
            return self._preempted
        from ..launch.mesh import all_ranks

        self._preempted = any(all_ranks(self.mesh, self._preempted))
        return self._preempted

    def _default_straggler_cb(self, step: int, dt: float, median: float):
        self._straggler_events.append(
            {"step": step, "dt": dt, "median": median})

    # -- main loop ----------------------------------------------------------

    def run(self) -> Dict[str, Any]:
        self._install_signal_handlers()
        os.makedirs(self.cfg.ckpt_dir, exist_ok=True)
        logs = self.mesh is None or self.mesh.rank == 0
        log_path = os.path.join(self.cfg.ckpt_dir, "metrics.jsonl")
        state, start = self._resume_or_init()
        device = _device_of(state)
        last_metrics: Dict[str, float] = {}
        with (open(log_path, "a") if logs else contextlib.nullcontext()) \
                as log:
            for step in range(start, self.cfg.total_steps):
                t0 = time.perf_counter()
                batch = self.batches(step)
                state, metrics = self.train_step(state, batch)
                if device is not None and device.type == "cuda":
                    torch.cuda.synchronize(device)
                dt = time.perf_counter() - t0
                self._watch_straggler(step, dt)
                last_metrics = {k: float(v) for k, v in metrics.items()}
                if logs and (step % self.cfg.log_every == 0 or
                             step == self.cfg.total_steps - 1):
                    rec = {"step": step, "dt_s": dt, **last_metrics}
                    log.write(json.dumps(rec) + "\n")
                    log.flush()
                preempted = self._any_preempted()
                boundary = (step + 1) % self.cfg.ckpt_every == 0
                if boundary or preempted or \
                        step == self.cfg.total_steps - 1:
                    save_checkpoint(self.cfg.ckpt_dir, step + 1, state,
                                    keep_last=self.cfg.keep_last,
                                    mesh=self.mesh, specs=self.specs)
                if preempted:
                    return {"state": state, "stopped_at": step + 1,
                            "preempted": True, "metrics": last_metrics,
                            "stragglers": self._straggler_events}
        return {"state": state, "stopped_at": self.cfg.total_steps,
                "preempted": False, "metrics": last_metrics,
                "stragglers": self._straggler_events}

    def _watch_straggler(self, step: int, dt: float):
        w = self._step_times
        w.append(dt)
        if len(w) > self.cfg.straggler_window:
            w.pop(0)
        if len(w) >= 8:
            med = statistics.median(w)
            if dt > self.cfg.straggler_factor * med:
                self.straggler_cb(step, dt, med)
