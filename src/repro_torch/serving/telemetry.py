"""Serving telemetry: counters, latency percentiles, synthesis histograms.

One ``Telemetry`` instance is shared by every thread of a ``PlanServer``
(client fast paths, queue workers, the background synthesizer); a single
lock makes every update and the whole ``snapshot()`` atomic, so the
exported numbers are mutually consistent -- ``requests`` always equals the
sum of its outcome counters at the instant of the snapshot, never a torn
mid-update view.

The schema of ``snapshot()`` (JSON-compatible throughout; see DESIGN.md
section 2):

    {
      "counters":  {"requests": int, "hits": int, "warm": int, ...},
      "latency":   {tier_name: {"count", "p50_us", "p90_us", "p99_us",
                                "max_us"}},
      "synthesis": {"count": int, "seconds_sum": float,
                    "hist": {"<=1e-05s": int, "<=0.0001s": int, ...}},
      "repair":    {"count": int, "residual_sum": float,
                    "hist": {"<=0.01": int, ..., ">1": int}},
      "queue":     {"depth": int, "peak_depth": int},
      "fabric":    {"version": int, "events": int,
                    "last_event": str | None},
    }
"""

from __future__ import annotations

import json
from typing import Dict, List

import numpy as np

from ..analysis.locks import make_lock

__all__ = ["Telemetry", "LatencyReservoir"]


class LatencyReservoir:
    """Bounded sample buffer with percentile extraction.

    Keeps the most recent ``capacity`` samples (a ring): serving telemetry
    wants *recent* latency percentiles, and an unbounded list would grow
    without limit in a long-running daemon.
    """

    def __init__(self, capacity: int = 4096):
        if capacity < 1:
            raise ValueError("capacity must be >= 1")
        self.capacity = capacity
        self._buf: List[float] = []
        self._next = 0  # ring cursor once the buffer is full
        self.count = 0  # total ever observed
        self.max_value = 0.0

    def add(self, value: float) -> None:
        value = float(value)
        if len(self._buf) < self.capacity:
            self._buf.append(value)
        else:
            self._buf[self._next] = value
            self._next = (self._next + 1) % self.capacity
        self.count += 1
        if value > self.max_value:
            self.max_value = value

    def percentile(self, q: float) -> float:
        if not self._buf:
            return 0.0
        return float(np.percentile(np.asarray(self._buf), q))

    def summary_us(self) -> Dict[str, float]:
        """count + p50/p90/p99/max in microseconds (JSON-ready)."""
        if not self._buf:
            return {"count": self.count, "p50_us": 0.0, "p90_us": 0.0,
                    "p99_us": 0.0, "max_us": 0.0}
        arr = np.asarray(self._buf) * 1e6
        p50, p90, p99 = np.percentile(arr, [50, 90, 99])
        return {"count": self.count, "p50_us": float(p50),
                "p90_us": float(p90), "p99_us": float(p99),
                "max_us": self.max_value * 1e6}


# Log-decade bucket edges for synthesis wall time, in seconds: 10us is the
# paper's small-cluster synthesis scale, minutes the pathological ceiling.
_SYNTH_EDGES = (1e-5, 1e-4, 1e-3, 1e-2, 1e-1, 1.0, 10.0, 100.0)

# Residual-fraction edges for warm repair: how much of each miss's traffic
# fell outside the previous plan's permutations.  The tail bucket past the
# default 0.25 bail threshold counts repairs that tripped to cold, so the
# histogram shows directly whether a deployment's drift fits its
# RepairConfig.
_REPAIR_EDGES = (0.01, 0.05, 0.10, 0.25, 0.50, 1.0)


class Telemetry:
    """Thread-safe serving metrics with an atomic JSON snapshot."""

    def __init__(self, latency_capacity: int = 4096):
        self._lock = make_lock("Telemetry._lock")
        self._counters: Dict[str, int] = {}
        self._latency: Dict[str, LatencyReservoir] = {}
        self._latency_capacity = latency_capacity
        self._synth_hist = [0] * (len(_SYNTH_EDGES) + 1)
        self._synth_count = 0
        self._synth_sum = 0.0
        self._repair_hist = [0] * (len(_REPAIR_EDGES) + 1)
        self._repair_count = 0
        self._repair_sum = 0.0
        self._queue_depth = 0
        self._queue_peak = 0
        self._fabric_version = 0
        self._fabric_events = 0
        self._fabric_last: str = ""

    def count(self, name: str, n: int = 1) -> None:
        with self._lock:
            self._counters[name] = self._counters.get(name, 0) + n

    def get(self, name: str) -> int:
        with self._lock:
            return self._counters.get(name, 0)

    def observe_latency(self, tier_name: str, seconds: float) -> None:
        with self._lock:
            res = self._latency.get(tier_name)
            if res is None:
                res = self._latency[tier_name] = LatencyReservoir(
                    self._latency_capacity)
            res.add(seconds)

    def observe_synthesis(self, seconds: float) -> None:
        with self._lock:
            i = int(np.searchsorted(_SYNTH_EDGES, seconds))
            self._synth_hist[i] += 1
            self._synth_count += 1
            self._synth_sum += float(seconds)

    def observe_repair_residual(self, fraction: float) -> None:
        """Record one warm-repair attempt's residual fraction (the share
        of the new matrix that fell outside the previous plan's slots)."""
        with self._lock:
            i = int(np.searchsorted(_REPAIR_EDGES, fraction))
            self._repair_hist[i] += 1
            self._repair_count += 1
            self._repair_sum += float(fraction)

    def observe_fabric_event(self, version: int, description: str) -> None:
        """Record one applied fabric event (serving/events.py): the
        daemon's current fabric version plus a human-readable tail."""
        with self._lock:
            self._fabric_version = int(version)
            self._fabric_events += 1
            self._fabric_last = description

    def observe_queue_depth(self, depth: int) -> None:
        with self._lock:
            self._queue_depth = int(depth)
            if depth > self._queue_peak:
                self._queue_peak = int(depth)

    def latency_percentile(self, tier_name: str, q: float) -> float:
        with self._lock:
            res = self._latency.get(tier_name)
            return res.percentile(q) if res is not None else 0.0

    def snapshot(self) -> Dict:
        """One consistent, JSON-compatible view of everything."""
        with self._lock:
            hist = {}
            for i, count in enumerate(self._synth_hist):
                label = (f"<={_SYNTH_EDGES[i]:g}s"
                         if i < len(_SYNTH_EDGES)
                         else f">{_SYNTH_EDGES[-1]:g}s")
                hist[label] = count
            repair_hist = {}
            for i, count in enumerate(self._repair_hist):
                label = (f"<={_REPAIR_EDGES[i]:g}"
                         if i < len(_REPAIR_EDGES)
                         else f">{_REPAIR_EDGES[-1]:g}")
                repair_hist[label] = count
            return {
                "counters": dict(self._counters),
                "latency": {name: res.summary_us()
                            for name, res in self._latency.items()},
                "synthesis": {"count": self._synth_count,
                              "seconds_sum": self._synth_sum,
                              "hist": hist},
                "repair": {"count": self._repair_count,
                           "residual_sum": self._repair_sum,
                           "hist": repair_hist},
                "queue": {"depth": self._queue_depth,
                          "peak_depth": self._queue_peak},
                "fabric": {"version": self._fabric_version,
                           "events": self._fabric_events,
                           "last_event": self._fabric_last or None},
            }

    def to_json(self, indent: int = 2) -> str:
        return json.dumps(self.snapshot(), indent=indent, sort_keys=True)
