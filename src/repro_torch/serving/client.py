"""Client-side adapter for the plan-serving daemon.

``PlanClient`` is the piece launch scripts and training loops hold: it
pins the request policy (algorithm, tier, timeout) once, then exposes the
same verbs as the inline path -- ``get_plan``, ``simulate``,
``simulate_many`` -- so routing a job through the daemon is a one-line
swap.

Failure policy (the client's half of fault tolerance): a transient
daemon failure -- queue saturated (``AdmissionError``) or a per-attempt
timeout -- is retried with bounded exponential backoff, because during a
fabric-event window the daemon is busy re-repairing and a moment later
usually answers.  A ``ServerClosed`` is terminal and is never retried.
When the retries (or the overall ``deadline``) are exhausted, the client
falls back to inline synthesis by default: the daemon is an accelerator,
never a new single point of failure.  Fallback answers are tagged
``source="inline"`` and tallied in the client's own counters, alongside
``retries``.  The clock and sleep are injectable so tests drive the
backoff schedule without real waiting.
"""

from __future__ import annotations

import time
from typing import Callable, Dict, List, Optional, Sequence

from ..core.plan import traffic_fingerprint
from ..core.schedulers import get_scheduler
from ..core.simulator import SimResult, execute_plan
from ..core.traffic import Workload
from .queue import AdmissionError, ServerClosed, Tier
from .server import PlanAnswer, PlanServer

__all__ = ["PlanClient"]


class PlanClient:
    """One job's handle on a shared ``PlanServer``.

    Args:
      server: the daemon to route plan requests through.
      algorithm: scheduler registry name used for every request.
      tier: queue priority for this client's requests.
      timeout: seconds to wait for an answer *per attempt* before the
        attempt counts as failed.
      inline_fallback: when False, exhausted retries raise instead of
        silently synthesizing locally (benchmarks that must measure only
        the daemon set this).
      max_retries: transient failures (AdmissionError, attempt timeout)
        retried this many times after the first attempt, with bounded
        exponential backoff (``backoff_base * 2**k``, capped at
        ``backoff_cap``).  0 restores fail-fast.
      deadline: overall wall-clock budget across all attempts and
        backoffs; None means only ``timeout``/``max_retries`` bound the
        wait.  Attempt timeouts and backoff sleeps are trimmed to the
        remaining budget.
      clock / sleep: injectable time sources (tests use a fake clock to
        verify the backoff schedule deterministically).
    """

    def __init__(self, server: PlanServer, *, algorithm: str = "flash",
                 tier: Tier = Tier.INTERACTIVE,
                 timeout: Optional[float] = 60.0,
                 inline_fallback: bool = True,
                 max_retries: int = 2,
                 backoff_base: float = 0.05,
                 backoff_cap: float = 1.0,
                 deadline: Optional[float] = None,
                 clock: Callable[[], float] = time.monotonic,
                 sleep: Callable[[float], None] = time.sleep):
        if max_retries < 0:
            raise ValueError("max_retries must be >= 0")
        if backoff_base < 0 or backoff_cap < 0:
            raise ValueError("backoff must be nonnegative")
        if deadline is not None and deadline <= 0:
            raise ValueError("deadline must be positive (or None)")
        self.server = server
        self.algorithm = algorithm
        self.tier = tier
        self.timeout = timeout
        self.inline_fallback = inline_fallback
        self.max_retries = max_retries
        self.backoff_base = backoff_base
        self.backoff_cap = backoff_cap
        self.deadline = deadline
        self._clock = clock
        self._sleep = sleep
        self.counters: Dict[str, int] = {
            "requests": 0, "hit": 0, "warm": 0, "cold": 0, "inline": 0,
            "coalesced": 0, "retries": 0, "lowered": 0}

    # -- retry plumbing ----------------------------------------------------

    def _remaining(self, start: float) -> Optional[float]:
        """Seconds left in the overall deadline (None = unbounded)."""
        if self.deadline is None:
            return None
        return self.deadline - (self._clock() - start)

    def _attempt_timeout(self, start: float) -> Optional[float]:
        remaining = self._remaining(start)
        if remaining is None:
            return self.timeout
        if self.timeout is None:
            return remaining
        return min(self.timeout, remaining)

    def _backoff(self, attempt: int) -> float:
        """Delay before retry ``attempt`` (1-based), exponential, capped."""
        return min(self.backoff_cap, self.backoff_base * (2.0 ** (attempt - 1)))

    def get_plan(self, w: Workload) -> PlanAnswer:
        """A served plan for ``w`` -- from the daemon (with retries), or
        inline fallback once retries/deadline are exhausted."""
        self.counters["requests"] += 1
        start = self._clock()
        attempt = 0
        answer: Optional[PlanAnswer] = None
        last_exc: Optional[Exception] = None
        while answer is None:
            remaining = self._remaining(start)
            if remaining is not None and remaining <= 0:
                break  # deadline spent before this attempt could start
            try:
                answer = self.server.request(
                    w, self.algorithm, self.tier,
                    timeout=self._attempt_timeout(start))
            except ServerClosed as exc:
                last_exc = exc
                break  # terminal: a stopped server will not come back
            except (AdmissionError, TimeoutError) as exc:
                last_exc = exc
                attempt += 1
                if attempt > self.max_retries:
                    break
                delay = self._backoff(attempt)
                remaining = self._remaining(start)
                if remaining is not None:
                    if remaining <= 0:
                        break
                    delay = min(delay, remaining)
                self.counters["retries"] += 1
                if delay > 0:
                    self._sleep(delay)
        if answer is None:
            if not self.inline_fallback:
                raise last_exc if last_exc is not None else TimeoutError(
                    "plan request deadline exhausted")
            answer = self._inline(w)
        self.counters[answer.source] = self.counters.get(answer.source,
                                                         0) + 1
        return answer

    def _inline(self, w: Workload) -> PlanAnswer:
        t0 = time.perf_counter()
        scheduler = get_scheduler(self.algorithm)
        key = traffic_fingerprint(w, self.algorithm)
        plan = scheduler.synthesize(w, fingerprint=key)
        plan.compile()
        return PlanAnswer(plan=plan, source="inline", exact=True,
                          latency_s=time.perf_counter() - t0,
                          request_id=-1, tier=self.tier)

    def get_device_schedule(self, w: Workload, *,
                            n_pods: Optional[int] = None):
        """A served plan *plus* its device lowering, as ``(answer, sched)``.

        The handoff that closes the serving loop: clients that execute the
        exchange on device (``comm.plan_exec.plan_all_to_all``) need the
        lowered stage tables, not just the Plan.  The lowering is memoized
        on the plan object itself, so a daemon cache hit hands back the
        already-lowered schedule for free; ``counters["lowered"]`` tallies
        only the requests that actually ran the lowering (cache misses).
        """
        from ..comm.plan_exec import is_lowered, lower_plan

        answer = self.get_plan(w)
        if not is_lowered(answer.plan, n_pods=n_pods):
            self.counters["lowered"] += 1
        return answer, lower_plan(answer.plan, n_pods=n_pods)

    def simulate(self, w: Workload) -> SimResult:
        """Inline-path-compatible simulate: plan via the daemon, then
        execute the workload against it."""
        return execute_plan(self.get_plan(w).plan, w)

    def simulate_many(self, workloads: Sequence[Workload]
                      ) -> List[SimResult]:
        """Trajectory simulate with client-side coalescing: one daemon
        request per *distinct* traffic fingerprint, not per workload.

        MoE drift trajectories revisit signatures (the paper's repeat
        mix); issuing a ticket per workload floods the queue with
        near-duplicate misses that the server repairs independently.
        Resolving each fingerprint once and re-executing the shared plan
        keeps the queue at the trajectory's distinct-matrix cardinality;
        ``counters["coalesced"]`` tallies the requests saved."""
        answers: Dict[str, PlanAnswer] = {}
        out: List[SimResult] = []
        for w in workloads:
            key = traffic_fingerprint(w, self.algorithm)
            answer = answers.get(key)
            if answer is None:
                answer = self.get_plan(w)
                answers[key] = answer
            else:
                self.counters["coalesced"] += 1
            out.append(execute_plan(answer.plan, w))
        return out
