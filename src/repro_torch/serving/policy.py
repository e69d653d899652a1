"""Cache lifetime and prewarming policy for the plan-serving daemon.

Two policies compose with the PlanCache's LRU rather than replacing it:

  * ``TTLPolicy`` -- entries expire by *age*, not just by recency of use.
    LRU alone keeps a hot fingerprint alive forever, but in a serving
    daemon a months-old plan for a still-popular signature pins memory
    for traffic whose surrounding family has long since drifted; a TTL
    bounds staleness.  The server consults ``expired`` on every lookup
    (an expired hit is served as a miss and evicted) and may ``sweep``
    opportunistically.

  * ``DriftPredictor`` -- dynamic MoE traffic moves along a trajectory:
    iteration t+1's matrix is usually iteration t's plus a small routing
    shift.  The predictor keeps the last two distinct matrices per
    (cluster, topology, algorithm) family and linearly extrapolates the
    next one (``2 * last - prev``, clipped nonnegative, diagonal zeroed).
    The daemon synthesizes the prediction at BACKGROUND priority before
    any client asks: an exact guess becomes a fast-path cache hit, and
    even a near miss refreshes the family head so the next warm repair
    starts from a plan one drift step closer to the request.
"""

from __future__ import annotations

import time
from collections import OrderedDict
from typing import Callable, List, Optional, Tuple

import numpy as np

from ..analysis.locks import make_lock
from ..core.plan import PlanCache, cluster_family_key
from ..core.traffic import Workload

__all__ = ["TTLPolicy", "DriftPredictor"]


class TTLPolicy:
    """Age out cache entries ``ttl_seconds`` after insertion.

    ``ttl_seconds=None`` disables expiry (every check returns False), so
    a server can always carry a policy object.  Thread-safe; the clock is
    injectable for tests.
    """

    def __init__(self, ttl_seconds: Optional[float] = None,
                 clock: Callable[[], float] = time.monotonic):
        if ttl_seconds is not None and ttl_seconds <= 0:
            raise ValueError("ttl_seconds must be positive (or None)")
        self.ttl_seconds = ttl_seconds
        self._clock = clock
        self._lock = make_lock("TTLPolicy._lock")
        self._born: "OrderedDict[str, float]" = OrderedDict()

    def note_insert(self, key: str) -> None:
        with self._lock:
            self._born[key] = self._clock()
            self._born.move_to_end(key)

    def forget(self, key: str) -> None:
        with self._lock:
            self._born.pop(key, None)

    def expired(self, key: str) -> bool:
        if self.ttl_seconds is None:
            return False
        with self._lock:
            born = self._born.get(key)
            if born is None:
                return False  # not tracked (inserted before the policy)
            return (self._clock() - born) > self.ttl_seconds

    def sweep(self, cache: PlanCache, limit: Optional[int] = None
              ) -> List[str]:
        """Evict every expired entry from ``cache``; returns evicted keys.

        Insertion order makes the scan short: entries age in the order
        they were born, so the walk stops at the first live one.
        """
        if self.ttl_seconds is None:
            return []
        evicted: List[str] = []
        with self._lock:
            now = self._clock()
            for key, born in self._born.items():
                if (now - born) <= self.ttl_seconds:
                    break
                evicted.append(key)
                if limit is not None and len(evicted) >= limit:
                    break
            for key in evicted:
                del self._born[key]
        for key in evicted:
            cache.evict(key)
        return evicted


class DriftPredictor:
    """Extrapolate the likely-next traffic matrix per plan family.

    ``observe`` feeds the request stream in arrival order; ``predict``
    returns candidate Workloads worth synthesizing ahead of demand.  Only
    the last two *distinct* matrices per family are kept (exact repeats
    carry no drift signal), bounded to ``max_families`` LRU families so a
    daemon serving many fabrics cannot grow without bound.
    """

    def __init__(self, max_families: int = 64):
        if max_families < 1:
            raise ValueError("max_families must be >= 1")
        self.max_families = max_families
        self._lock = make_lock("DriftPredictor._lock")
        # family key -> (workload template, [prev_matrix, last_matrix],
        #                algorithm)
        self._families: "OrderedDict[str, Tuple[Workload, List[np.ndarray], str]]"  # noqa: E501
        self._families = OrderedDict()

    def observe(self, w: Workload, algorithm: str) -> None:
        family = cluster_family_key(w, algorithm)
        with self._lock:
            entry = self._families.get(family)
            if entry is None:
                self._families[family] = (w, [w.matrix], algorithm)
            else:
                history = entry[1]
                if not np.array_equal(history[-1], w.matrix):
                    history.append(w.matrix)
                    del history[:-2]  # keep (prev, last)
                self._families[family] = (w, history, algorithm)
            self._families.move_to_end(family)
            while len(self._families) > self.max_families:
                self._families.popitem(last=False)

    def predict(self, w: Workload, algorithm: str) -> List[Workload]:
        """Likely-next workloads for ``w``'s family (possibly empty).

        Linear extrapolation of the last drift step; requires two distinct
        observed matrices and a nonzero delta, and never predicts a matrix
        identical to the last observation (that one is already cached).
        """
        family = cluster_family_key(w, algorithm)
        with self._lock:
            entry = self._families.get(family)
            if entry is None or len(entry[1]) < 2:
                return []
            template, (prev, last), _ = entry
        nxt = np.maximum(2.0 * last - prev, 0.0)
        np.fill_diagonal(nxt, 0.0)
        if np.array_equal(nxt, last):
            return []
        return [Workload(template.cluster, nxt, template.topology)]

    def families(self) -> int:
        with self._lock:
            return len(self._families)

    def snapshot(self) -> List[Tuple[str, Workload, str]]:
        """Every tracked family's latest traffic, MRU last: ``(family
        key, workload carrying the last observed matrix, algorithm)``.

        The fabric-event re-repair walk consumes this -- the predictor is
        the one component that already knows, per family, *what traffic
        to re-plan for* on the new topology."""
        with self._lock:
            return [(family, Workload(w.cluster, history[-1], w.topology),
                     algo)
                    for family, (w, history, algo)
                    in self._families.items()]

    def rehome(self, old_fingerprint: str, topology) -> int:
        """Migrate families observed on a pre-event fabric to the new one.

        Keeps each family's drift history (prev/last matrices) across a
        fabric event, so prewarming keeps predicting through the event
        window instead of restarting cold under the new family keys.
        Returns the number of families migrated."""
        with self._lock:
            moved = 0
            for family in list(self._families.keys()):
                w, history, algo = self._families[family]
                t = w.topo
                if t.fingerprint() != old_fingerprint:
                    continue
                if (t.n_servers, t.m_gpus) != (topology.n_servers,
                                               topology.m_gpus):
                    continue
                new_w = Workload(w.cluster, w.matrix, topology)
                new_family = cluster_family_key(new_w, algo)
                self._families.pop(family)
                self._families[new_family] = (new_w, history, algo)
                moved += 1
            return moved
