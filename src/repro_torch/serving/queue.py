"""Priority-tiered plan-request queue with admission control.

The plan-serving daemon multiplexes many concurrent MoE jobs over a small
worker pool, so the queue -- not the synthesizer -- is where overload
policy lives:

  * **Tiers** -- ``INTERACTIVE`` (a serving replica blocked on its next
    dispatch schedule) drains before ``BATCH`` (training jobs that can
    ride one stale plan for an extra step), which drains before
    ``BACKGROUND`` (the daemon's own upgrade/prewarm work).  FIFO within
    a tier.
  * **Bounded depth** -- the queue never grows past ``max_depth``.  An
    arriving request first sheds stale queued work; if the queue is still
    full it preempts the newest request of a *strictly lower-priority*
    tier, and otherwise is rejected outright (``AdmissionError``) -- a
    full queue of equal-or-higher-priority work means the daemon is
    saturated and the client should fall back to inline synthesis rather
    than pile on.
  * **Per-tier staleness** -- a request older than its tier's
    ``stale_after`` horizon is shed instead of served: an interactive
    client has long since timed out, and synthesizing for it anyway would
    burn worker time current requests need.  Shed and preempted requests
    fail their ticket with ``AdmissionError`` so no waiter blocks forever.

Every mutation happens under one lock; ``get`` blocks on a condition
variable, so worker threads idle without spinning.
"""

from __future__ import annotations

import dataclasses
import enum
import itertools
import threading
import time
from collections import deque
from typing import Callable, Deque, Dict, Mapping, Optional, Union

from ..analysis.locks import make_condition, make_lock
from ..core.plan import Plan
from ..core.traffic import Workload

__all__ = [
    "Tier",
    "AdmissionError",
    "ServerClosed",
    "PlanTicket",
    "PlanRequest",
    "TieredQueue",
    "DEFAULT_STALE_AFTER",
]


class Tier(enum.IntEnum):
    """Request priority; lower value drains first."""

    INTERACTIVE = 0
    BATCH = 1
    BACKGROUND = 2


class AdmissionError(RuntimeError):
    """The queue refused (or later shed) a request."""


class ServerClosed(RuntimeError):
    """The daemon is stopped; no request can be served."""


# Per-tier staleness horizons (seconds).  Interactive callers block on the
# answer and give up quickly; background upgrade/prewarm jobs stay useful
# for much longer.
DEFAULT_STALE_AFTER: Mapping[Tier, float] = {
    Tier.INTERACTIVE: 2.0,
    Tier.BATCH: 10.0,
    Tier.BACKGROUND: 60.0,
}

_req_ids = itertools.count()


class PlanTicket:
    """A waitable slot for one request's answer (a minimal future).

    ``result`` blocks until a worker (or the fast path) resolves the
    ticket; failures -- shed, rejected, server stopped, synthesis error --
    re-raise in the waiting thread.

    Resolution is first-write-wins: ``resolve``/``fail`` return whether
    this call settled the ticket, and later calls are no-ops.  The worker
    respawn path relies on this -- a dying worker's cleanup can blindly
    fail its last request without clobbering an answer that already
    reached the client (and without double-counting in telemetry).
    """

    def __init__(self):
        self._event = threading.Event()
        self._lock = make_lock("PlanTicket._lock")
        self._answer = None
        self._exc: Optional[BaseException] = None

    def resolve(self, answer) -> bool:
        with self._lock:
            if self._event.is_set():
                return False
            self._answer = answer
            self._event.set()
            return True

    def fail(self, exc: BaseException) -> bool:
        with self._lock:
            if self._event.is_set():
                return False
            self._exc = exc
            self._event.set()
            return True

    def done(self) -> bool:
        return self._event.is_set()

    def result(self, timeout: Optional[float] = None):
        if not self._event.wait(timeout):
            raise TimeoutError("plan request not answered in time")
        if self._exc is not None:
            raise self._exc
        return self._answer


@dataclasses.dataclass(eq=False)
class PlanRequest:
    """One unit of daemon work.

    ``kind`` distinguishes client-facing plan requests from the daemon's
    own background jobs: ``"plan"`` (a client waits on ``ticket``),
    ``"upgrade"`` (replace a warm-repaired cache entry with the exact
    plan), ``"prewarm"`` (synthesize a predicted fingerprint ahead of
    demand) and ``"rerepair"`` (re-repair a plan family across a fabric
    event; see serving/events.py).  Background kinds carry no ticket.
    """

    workload: Workload
    algorithm: str
    tier: Tier = Tier.INTERACTIVE
    kind: str = "plan"
    key: str = ""  # traffic fingerprint, filled by the server
    created: float = 0.0  # queue clock timestamp, stamped at put()
    # Latency clock origin (time.perf_counter domain), stamped at
    # construction so *every* request carries one -- the telemetry path
    # reads it unconditionally, and a missing stamp is a loud
    # AttributeError instead of a silently-recorded ~0s latency.
    t_start: float = dataclasses.field(
        default_factory=time.perf_counter)
    ticket: Optional[PlanTicket] = None
    # Upgrade jobs remember the plan they are replacing, so telemetry can
    # prove the exact plan actually displaced a warm-repaired one.
    stale_plan: Optional[Plan] = None
    request_id: int = dataclasses.field(
        default_factory=lambda: next(_req_ids))

    def fail(self, exc: BaseException) -> bool:
        """Fail the waiter, if any; True when this call settled the
        ticket (first write), False for ticketless/already-settled
        requests."""
        if self.ticket is not None:
            return self.ticket.fail(exc)
        return False


def _normalize_stale(stale_after) -> Optional[Dict[Tier, float]]:
    if stale_after is None:
        return None
    if isinstance(stale_after, (int, float)):
        return {t: float(stale_after) for t in Tier}
    out = dict(DEFAULT_STALE_AFTER)
    out.update({Tier(k): float(v) for k, v in stale_after.items()})
    return out


class TieredQueue:
    """Bounded, tier-ordered request queue (see module docstring).

    Args:
      max_depth: total queued requests across all tiers.
      stale_after: staleness horizon -- per-tier mapping, one scalar for
        every tier, or None to disable shedding by age.  Defaults to
        ``DEFAULT_STALE_AFTER``.
      clock: monotonic time source (injectable for tests).
      on_shed: callback ``(request, reason)`` invoked after a request is
        shed/preempted/rejected, with reason in {"stale", "preempted",
        "rejected"} -- the server's telemetry hook.
    """

    def __init__(self, max_depth: int = 256,
                 stale_after: Union[None, float, Mapping] =
                 DEFAULT_STALE_AFTER,
                 clock: Callable[[], float] = time.monotonic,
                 on_shed: Optional[Callable] = None):
        if max_depth < 1:
            raise ValueError("max_depth must be >= 1")
        self.max_depth = max_depth
        self.stale_after = _normalize_stale(stale_after)
        self._clock = clock
        self._on_shed = on_shed
        self._lock = make_lock("TieredQueue._lock")
        self._not_empty = make_condition("TieredQueue._not_empty",
                                         self._lock)
        self._tiers: Dict[Tier, Deque[PlanRequest]] = {
            t: deque() for t in Tier}
        self._count = 0
        self._closed = False

    # -- internals (lock held) --------------------------------------------

    def _shed(self, req: PlanRequest, reason: str) -> None:
        req.fail(AdmissionError(
            f"request {req.request_id} ({req.kind}, tier "
            f"{req.tier.name}) {reason}"))
        if self._on_shed is not None:
            self._on_shed(req, reason)

    def _is_stale(self, req: PlanRequest, now: float) -> bool:
        if self.stale_after is None:
            return False
        return (now - req.created) > self.stale_after[req.tier]

    def _shed_stale_locked(self) -> int:
        """Drop every queued request older than its tier's horizon."""
        if self.stale_after is None:
            return 0
        now = self._clock()
        dropped = 0
        for tier, q in self._tiers.items():
            keep: Deque[PlanRequest] = deque()
            while q:
                req = q.popleft()
                if self._is_stale(req, now):
                    self._shed(req, "stale")
                    dropped += 1
                else:
                    keep.append(req)
            self._tiers[tier] = keep
        self._count -= dropped
        return dropped

    # -- public API -------------------------------------------------------

    def put(self, req: PlanRequest) -> None:
        """Admit a request, or raise ``AdmissionError``.

        Admission control under pressure, in order: shed stale queued
        requests; preempt the newest strictly-lower-priority queued
        request; reject the arrival.
        """
        with self._lock:
            if self._closed:
                raise ServerClosed("queue is closed")
            req.created = self._clock()
            if self._count >= self.max_depth:
                self._shed_stale_locked()
            if self._count >= self.max_depth:
                victim = None
                for tier in sorted(Tier, reverse=True):
                    if tier > req.tier and self._tiers[tier]:
                        victim = self._tiers[tier].pop()  # newest first
                        break
                if victim is not None:
                    self._count -= 1
                    self._shed(victim, "preempted")
                else:
                    self._shed(req, "rejected")
                    raise AdmissionError(
                        f"queue full ({self.max_depth} requests) with no "
                        f"lower-priority work to shed; tier "
                        f"{req.tier.name} request rejected")
            self._tiers[req.tier].append(req)
            self._count += 1
            self._not_empty.notify()

    def get(self, timeout: Optional[float] = None
            ) -> Optional[PlanRequest]:
        """Pop the oldest request of the highest-priority nonempty tier.

        Stale requests encountered on the way out are shed (their waiters
        unblocked), never served.  Returns None on timeout or once the
        queue is closed and drained.
        """
        deadline = None if timeout is None else self._clock() + timeout
        with self._lock:
            while True:
                now = self._clock()
                for tier in Tier:
                    q = self._tiers[tier]
                    while q:
                        req = q.popleft()
                        self._count -= 1
                        if self._is_stale(req, now):
                            self._shed(req, "stale")
                            continue
                        return req
                if self._closed:
                    return None
                if deadline is not None:
                    remaining = deadline - now
                    if remaining <= 0:
                        return None
                    self._not_empty.wait(remaining)
                else:
                    self._not_empty.wait()

    def close(self) -> None:
        """Stop admitting; fail all queued requests; wake every getter."""
        with self._lock:
            self._closed = True
            for q in self._tiers.values():
                while q:
                    q.popleft().fail(ServerClosed("server stopped"))
            self._count = 0
            self._not_empty.notify_all()

    def depth(self) -> int:
        with self._lock:
            return self._count

    def depths(self) -> Dict[str, int]:
        with self._lock:
            return {t.name: len(q) for t, q in self._tiers.items()}
