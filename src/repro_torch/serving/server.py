"""The plan-serving daemon: FLASH synthesis as a long-running service.

Every entry point into the scheduler used to be a one-shot function call;
``PlanServer`` turns it into a shared, concurrent service that owns one
warm-start ``PlanCache`` and amortizes synthesis across every MoE job
(serving replicas, training steps, benchmarks) that asks for a plan.

The request path is split so the common case never waits on a queue:

  * **Synchronous fast path** (caller's thread): fingerprint the traffic,
    look it up in the cache.  A live (non-TTL-expired) hit resolves the
    ticket immediately with the cached plan -- whose compiled
    ``ExecutableSchedule`` is already attached, because workers compile
    before inserting -- so a hit costs one hash plus one locked dict
    probe, microseconds next to any synthesis.
  * **Tiered queue + worker pool** (misses): workers drain the
    ``TieredQueue`` in priority order.  Requests for a fingerprint
    already being synthesized coalesce onto the in-flight computation
    (no thundering herd).  A miss is answered by the *best available*
    route: family near-miss -> ``try_repair_plan`` warm repair; cold ->
    ``synthesize_bounded`` under the server's latency budget.  Both
    degraded routes answer immediately and schedule a BACKGROUND
    **upgrade** job that re-synthesizes the exact plan and swaps it into
    the cache -- later hits serve the exact plan, and ``upgrades`` in the
    telemetry tallies every swap.
  * **Prewarming**: the ``DriftPredictor`` extrapolates each family's
    traffic trajectory one step ahead; predicted fingerprints are
    synthesized at BACKGROUND priority before any client requests them.

**Fabric events** (serving/events.py) make topology change a first-class
scenario instead of an implicit cache wipe: ``apply_fabric_event`` swaps
the server's active ``Topology``, walks the cache's family index and
re-repairs every affected plan family against the new pair capacities at
BACKGROUND priority (``"rerepair"`` jobs), and keeps serving throughout
-- requests carrying a pre-event fabric are re-homed onto the live one
(``stale_topology`` counter), and a post-event miss warm-repairs from
the old fabric's family head (``try_repair_plan(topology_change=True)``)
rather than synthesizing cold.  Workers that die on an unexpected
exception fail their in-flight ticket, clean up, and respawn in place
(``worker_deaths`` counter), so a crash never leaves a queue slot dead.

Lifecycle: ``start()``/``stop()`` or use as a context manager;
``drain()`` waits for the queue and background work to settle (tests and
benchmarks use it to observe the post-upgrade steady state);
``telemetry_snapshot()`` exports the full JSON metrics view (telemetry +
cache stats + queue depths).
"""

from __future__ import annotations

import dataclasses
import threading
import time
from typing import Dict, List, Optional, Union

from ..analysis.locks import make_lock
from ..core.plan import (
    Plan,
    PlanCache,
    cluster_family_key,
    traffic_fingerprint,
)
from ..core.schedulers import RepairConfig, Scheduler, get_scheduler
from ..core.topology import Topology
from ..core.traffic import Workload
from .events import FabricEvent, FabricMonitor
from .policy import DriftPredictor, TTLPolicy
from .queue import (
    AdmissionError,
    PlanRequest,
    PlanTicket,
    ServerClosed,
    TieredQueue,
    Tier,
)
from .telemetry import Telemetry

__all__ = ["PlanAnswer", "PlanServer"]


@dataclasses.dataclass(frozen=True)
class PlanAnswer:
    """One served plan plus its provenance.

    ``source`` is the route that produced the answer: ``"hit"`` (cache,
    including coalesced waiters), ``"warm"`` (repaired from a same-family
    plan), ``"cold"`` (synthesized now).  ``exact`` is False while the
    plan is a degraded answer (warm repair or over-budget bounded
    synthesis) awaiting its background upgrade.
    """

    plan: Plan
    source: str
    exact: bool
    latency_s: float
    request_id: int
    tier: Tier


class PlanServer:
    """Long-running, concurrent plan-serving daemon (module docstring).

    Args:
      cache: the PlanCache to own; default ``PlanCache(capacity=1024,
        warm_start=True)``.  Warm start matters: it is what turns family
        near-misses into repairs instead of cold syntheses.
      workers: queue-draining threads.  They serve interactive misses and,
        when idle, the BACKGROUND upgrade/prewarm tier.
      queue: the TieredQueue (constructed with the server's shed hook when
        omitted).
      ttl: entry lifetime -- seconds, a ``TTLPolicy``, or None (never
        expire).  Expired hits are served as misses and evicted.
      prewarm: predict-ahead synthesis of each family's next fingerprint.
      synth_budget_seconds: per-request synthesis latency budget handed to
        ``Scheduler.synthesize_bounded`` on the cold path; None = no
        budget (always exact).
      telemetry: shared Telemetry instance (constructed when omitted).
      repair_config: warm-repair knobs (``RepairConfig``) handed to
        ``try_repair_plan`` on the miss path -- the cold-fallback
        thresholds (residual fraction, stage drift, quality ratchet) and
        the incremental/one-shot engine switch.  None uses the
        scheduler's defaults.  Every repair attempt's residual fraction
        lands in the telemetry ``repair`` histogram.
      topology: the fabric this server believes is live.  Optional -- a
        server that never sees a fabric event does not need one.  Set it
        (or call ``attach_monitor``) to enable re-homing of requests that
        still carry a pre-event ``Topology`` and the event-driven
        re-repair walk in ``apply_fabric_event``.
    """

    def __init__(self, cache: Optional[PlanCache] = None, *,
                 workers: int = 2,
                 queue: Optional[TieredQueue] = None,
                 ttl: Union[None, float, TTLPolicy] = None,
                 prewarm: bool = True,
                 synth_budget_seconds: Optional[float] = None,
                 telemetry: Optional[Telemetry] = None,
                 predictor: Optional[DriftPredictor] = None,
                 repair_config: Optional[RepairConfig] = None,
                 topology: Optional[Topology] = None):
        if workers < 1:
            raise ValueError("workers must be >= 1")
        self.cache = cache if cache is not None else PlanCache(
            capacity=1024, warm_start=True)
        self.telemetry = telemetry if telemetry is not None else Telemetry()
        self.queue = queue if queue is not None else TieredQueue()
        if self.queue._on_shed is None:
            self.queue._on_shed = self._on_shed
        self.ttl = (ttl if isinstance(ttl, TTLPolicy)
                    else TTLPolicy(ttl_seconds=ttl))
        self.prewarm = prewarm
        self.synth_budget_seconds = synth_budget_seconds
        self.repair_config = repair_config
        self.predictor = (predictor if predictor is not None
                          else DriftPredictor())
        self._n_workers = workers
        self._threads: List[threading.Thread] = []
        self._lock = make_lock("PlanServer._lock")
        self._inflight: Dict[str, List[PlanRequest]] = {}
        self._background_keys: set = set()  # queued upgrade/prewarm keys
        self._inexact: set = set()          # cached keys awaiting upgrade
        self._prewarmed: Dict[str, None] = {}  # keys inserted by prewarm
        self._busy = 0  # requests popped from the queue, not yet finished
        self._running = False
        self._closed = False
        self._active_topo = topology
        self._fabric_version = 0
        # new-fabric family key -> old-fabric family key: lets a
        # post-event miss warm-repair from the pre-event family head
        # before any rerepair job has landed.  Insertion-ordered, bounded.
        self._family_alias: Dict[str, str] = {}
        # thread ident -> the request that thread is serving; consulted by
        # _worker_main when the worker dies so the ticket can be failed.
        self._dying: Dict[int, PlanRequest] = {}

    # -- lifecycle ---------------------------------------------------------

    def start(self) -> "PlanServer":
        with self._lock:
            if self._running:
                return self
            if self._closed:
                raise ServerClosed("server was stopped; build a new one")
            self._running = True
        for i in range(self._n_workers):
            t = threading.Thread(target=self._worker_main,
                                 name=f"plan-server-{i}", daemon=True)
            t.start()
            self._threads.append(t)
        return self

    def stop(self, timeout: float = 10.0) -> None:
        with self._lock:
            if self._closed:
                return
            self._closed = True
        self.queue.close()  # fails queued tickets, wakes idle workers
        for t in self._threads:
            t.join(timeout)
        self._threads.clear()
        with self._lock:
            self._running = False

    def __enter__(self) -> "PlanServer":
        return self.start()

    def __exit__(self, *exc) -> None:
        self.stop()

    def drain(self, timeout: float = 30.0) -> bool:
        """Block until no queued, in-flight or background work remains.

        Returns False on timeout.  Used to observe the settled state --
        every pending upgrade applied, every prewarm inserted."""
        deadline = time.monotonic() + timeout
        while time.monotonic() < deadline:
            with self._lock:
                busy = (self._busy > 0 or bool(self._inflight)
                        or bool(self._background_keys))
            if not busy and self.queue.depth() == 0:
                return True
            time.sleep(0.002)
        return False

    # -- client API --------------------------------------------------------

    def submit(self, w: Workload, algorithm: str = "flash",
               tier: Tier = Tier.INTERACTIVE) -> PlanTicket:
        """Request a plan; returns a ticket (resolved already on a hit)."""
        if self._closed or not self._running:
            raise ServerClosed(
                "PlanServer is not running (use `with PlanServer(...)`"
                " or call start())")
        t_start = time.perf_counter()
        self.telemetry.count("requests")
        w = self._rehome(w)
        self.predictor.observe(w, algorithm)
        key = traffic_fingerprint(w, algorithm)
        ticket = PlanTicket()
        plan = self._lookup_live(key, counted=True)
        if plan is not None:
            self._resolve_hit(ticket, plan, key, t_start, tier, w, algorithm)
            return ticket
        req = PlanRequest(workload=w, algorithm=algorithm, tier=tier,
                          kind="plan", key=key, ticket=ticket,
                          t_start=t_start)
        self.queue.put(req)  # raises AdmissionError when saturated
        self.telemetry.observe_queue_depth(self.queue.depth())
        return ticket

    def request(self, w: Workload, algorithm: str = "flash",
                tier: Tier = Tier.INTERACTIVE,
                timeout: Optional[float] = 60.0) -> PlanAnswer:
        """Synchronous ``submit``: block until the answer (or raise)."""
        return self.submit(w, algorithm, tier).result(timeout)

    def telemetry_snapshot(self) -> Dict:
        """Full JSON-compatible metrics view (DESIGN.md section 2)."""
        snap = self.telemetry.snapshot()
        snap["cache"] = self.cache.stats()
        snap["queue"]["depths"] = self.queue.depths()
        cfg = self.repair_config
        if cfg is not None:
            snap["repair"]["config"] = dataclasses.asdict(cfg)
        with self._lock:
            snap["pending_upgrades"] = len(self._inexact)
            if self._active_topo is not None:
                snap["fabric"]["topology"] = self._active_topo.fingerprint()
        return snap

    def audit(self) -> Dict:
        """Run the workload-independent plan verifier over the live cache.

        Walks every family head (``cache.family_heads()``) through
        ``analysis.planlint``: incast-freedom, self-traffic, slot
        feasibility, stage ordering, topology consistency, and
        family-index agreement -- the FAST structural guarantees, checked
        on the plans this daemon is actually serving rather than on a
        workload-coupled ``validate`` at synthesis time.  Returns the
        planlint report (``{"plans", "clean", "issues": [...]}``); the
        ``audits``/``audit_issues`` counters land in telemetry so a soak
        or an operator snapshot shows at a glance whether a degraded
        route ever cached a structurally bad plan.
        """
        from ..analysis import planlint

        report = planlint.audit_cache(self.cache)
        self.telemetry.count("audits")
        if report["issues"]:
            self.telemetry.count("audit_issues", len(report["issues"]))
        return report

    # -- fabric events -----------------------------------------------------

    def attach_monitor(self, monitor: FabricMonitor) -> "PlanServer":
        """Adopt ``monitor``'s fabric as active and subscribe to its
        events; every later ``inject`` flows into ``apply_fabric_event``
        (strictly version-ordered -- the monitor notifies under its
        lock).

        The monitor state is snapshotted *before* taking the server
        lock: ``inject`` acquires FabricMonitor._lock then (via this
        subscription) PlanServer._lock, so reading the monitor while
        holding the server lock would acquire the same two locks in the
        opposite order -- a deadlock window the lock-order analysis
        flags as a cycle.  An event injected between the snapshot and
        the subscribe is not lost: the next delivered event carries the
        authoritative post-event topology explicitly."""
        version, topo = monitor.snapshot()
        with self._lock:
            self._active_topo = topo
            self._fabric_version = version
        monitor.subscribe(self.apply_fabric_event)
        return self

    def apply_fabric_event(self, event: FabricEvent,
                           topology: Optional[Topology] = None) -> int:
        """Swap the active fabric and re-repair every affected family.

        The serving answer to a NIC degrading or dying is *bounded
        slowdown*, not a stall: the cache is never wiped.  Each family
        the DriftPredictor tracks on the outgoing fabric gets (a) a
        BACKGROUND ``"rerepair"`` job that warm-repairs its head plan
        against the new pair capacities, and (b) a family alias so a
        client miss that arrives before the job lands still repairs from
        the old head synchronously instead of synthesizing cold.

        ``topology`` overrides the post-event fabric (used when the
        caller already constructed it); otherwise ``event.apply`` derives
        it from the current one.  Events at or below the last applied
        version are ignored (a late-delivered duplicate must not re-swap
        a fabric that has since moved on).  Returns the number of
        families scheduled for re-repair.
        """
        with self._lock:
            if event.version and event.version <= self._fabric_version:
                stale = True
                old = new = None
            else:
                stale = False
                old = self._active_topo
                new = topology
                if new is None:
                    if old is None:
                        raise ValueError(
                            "no active topology: construct with"
                            " PlanServer(topology=...), call"
                            " attach_monitor(), or pass topology=")
                    new = event.apply(old)
                self._active_topo = new
                self._fabric_version = (event.version
                                        or self._fabric_version + 1)
            version = self._fabric_version
        if stale:
            self.telemetry.count("fabric_events_stale")
            return 0
        self.telemetry.count("fabric_events")
        self.telemetry.observe_fabric_event(version, event.describe())
        return self._rerepair_families(old, new)

    def _rehome(self, w: Workload) -> Workload:
        """Move a request riding a stale fabric onto the active one.

        Clients built before a fabric event keep submitting workloads
        whose ``Topology`` predates it; planning against that fabric
        would produce schedules the real network can no longer honor.
        Only same-shape fabrics are re-homed -- a genuinely different
        cluster is the client's business, not staleness."""
        active = self._active_topo
        if active is None:
            return w
        topo = w.topo
        if topo is active or topo.fingerprint() == active.fingerprint():
            return w
        if (topo.n_servers, topo.m_gpus) != (active.n_servers,
                                             active.m_gpus):
            return w
        self.telemetry.count("stale_topology")
        return Workload(w.cluster, w.matrix, active)

    def _rerepair_families(self, old: Optional[Topology],
                           new: Topology) -> int:
        """Schedule one BACKGROUND rerepair per family planned on ``old``.

        The PlanCache family index knows the *plans* (``family_heads``);
        the DriftPredictor knows the *traffic* each family last saw.
        Joining them gives the work list: re-plan the last observed
        matrix of every family whose head rode the outgoing fabric."""
        if old is None:
            return 0
        old_fp = old.fingerprint()
        heads = {family: plan for family, plan in self.cache.family_heads()
                 if plan.topo.fingerprint() == old_fp}
        scheduled = 0
        for family, w_last, algo in self.predictor.snapshot():
            prev = heads.get(family)
            if prev is None or w_last.topo.fingerprint() != old_fp:
                continue
            w_new = Workload(w_last.cluster, w_last.matrix, new)
            with self._lock:
                self._family_alias[cluster_family_key(w_new, algo)] = family
                while len(self._family_alias) > 256:
                    self._family_alias.pop(next(iter(self._family_alias)))
            self._schedule_background(
                "rerepair", w_new, algo,
                traffic_fingerprint(w_new, algo), stale_plan=prev)
            scheduled += 1
        self.predictor.rehome(old_fp, new)
        return scheduled

    # -- fast-path helpers -------------------------------------------------

    def _lookup_live(self, key: str, counted: bool) -> Optional[Plan]:
        """Cache probe with TTL: an expired entry is evicted and reported
        as a miss.  ``counted`` selects the hit/miss-counting ``lookup``
        (client fast path) vs the silent ``peek`` (worker re-check of a
        miss that was already counted)."""
        if self.ttl.expired(key):
            self.cache.evict(key)
            self.ttl.forget(key)
            with self._lock:
                self._inexact.discard(key)
            self.telemetry.count("expired")
        return self.cache.lookup(key) if counted else self.cache.peek(key)

    def _resolve_hit(self, ticket: PlanTicket, plan: Plan, key: str,
                     t_start: float, tier: Tier, w: Workload,
                     algorithm: str) -> None:
        with self._lock:
            exact = key not in self._inexact
            was_prewarmed = self._prewarmed.pop(key, False) is None
        self.telemetry.count("hits")
        if was_prewarmed:
            self.telemetry.count("prewarm_hits")
        if not exact:
            # The cached answer is still a degraded plan (its upgrade was
            # shed or is queued behind other work): make sure an upgrade
            # is in flight again.
            self._schedule_background("upgrade", w, algorithm, key,
                                      stale_plan=plan)
        latency = time.perf_counter() - t_start
        self.telemetry.observe_latency(tier.name, latency)
        ticket.resolve(PlanAnswer(plan=plan, source="hit", exact=exact,
                                  latency_s=latency,
                                  request_id=-1, tier=tier))

    # -- worker side -------------------------------------------------------

    def _worker_main(self) -> None:
        """Thread target: run ``_worker_loop`` and survive its death.

        The loop's inner ``except Exception`` backstop already keeps
        ordinary synthesis failures from killing a worker, but anything
        that escapes it (a raising telemetry hook, ``KeyboardInterrupt``,
        a bug in the loop itself) used to take the thread down and leave
        its queue slot dead forever.  Now the dying worker fails the
        ticket it was holding (first-write-wins on ``PlanTicket`` makes
        the blind ``fail`` safe), releases its in-flight registration so
        coalesced waiters are not stranded, counts ``worker_deaths``, and
        respawns in place -- same thread, fresh loop."""
        ident = threading.get_ident()
        while True:
            try:
                self._worker_loop()
                return  # clean shutdown
            except BaseException as exc:
                req = self._dying.pop(ident, None)
                if req is not None:
                    if req.fail(exc):
                        self.telemetry.count("errors")
                    with self._lock:
                        waiters = self._inflight.get(req.key)
                        # Only yank the registration this request owns; a
                        # coalesced waiter's list belongs to another
                        # (live) worker.
                        if waiters and waiters[0] is req:
                            del self._inflight[req.key]
                        else:
                            waiters = None
                        if req.kind != "plan":
                            self._background_keys.discard(req.key)
                    for r in waiters or ():
                        if r is not req and r.fail(exc):
                            self.telemetry.count("errors")
                self.telemetry.count("worker_deaths")
                with self._lock:
                    if self._closed:
                        return

    def _worker_loop(self) -> None:
        ident = threading.get_ident()
        while True:
            req = self.queue.get(timeout=0.1)
            if req is None:
                if self._closed:
                    return
                # Idle housekeeping: age out expired entries in bites.
                for key in self.ttl.sweep(self.cache, limit=32):
                    self.ttl.forget(key)
                    with self._lock:
                        self._inexact.discard(key)
                    self.telemetry.count("expired")
                continue
            self._dying[ident] = req
            with self._lock:
                self._busy += 1
            try:
                if req.kind == "plan":
                    self._serve(req)
                elif req.kind == "upgrade":
                    self._upgrade(req)
                elif req.kind == "rerepair":
                    self._rerepair_job(req)
                else:
                    self._prewarm_job(req)
            except Exception as exc:  # backstop: never kill a worker
                # "errors" only when a client ticket actually failed --
                # counting ticketless background failures there would
                # break the requests == sum(outcomes) conservation law.
                if req.fail(exc):
                    self.telemetry.count("errors")
                else:
                    self.telemetry.count("background_errors")
            finally:
                with self._lock:
                    self._busy -= 1
                    if req.kind != "plan":
                        self._background_keys.discard(req.key)
            self._dying.pop(ident, None)  # settled without dying

    def _scheduler(self, algorithm: str) -> Scheduler:
        # get_scheduler builds a fresh stateless instance; cheap enough
        # that memoizing it here would only add another shared-state lock.
        return get_scheduler(algorithm)

    def _serve(self, req: PlanRequest) -> None:
        key = req.key
        with self._lock:
            waiters = self._inflight.get(key)
            if waiters is not None:
                # Same fingerprint already being synthesized: ride it.
                waiters.append(req)
                self.telemetry.count("coalesced")
                return
            self._inflight[key] = [req]
        plan: Optional[Plan] = None
        source, exact = "hit", True
        err: Optional[BaseException] = None
        try:
            plan = self._lookup_live(key, counted=False)
            if plan is None:
                plan, source, exact = self._synthesize_best(req)
        except BaseException as e:
            err = e
        finally:
            with self._lock:
                waiters = self._inflight.pop(key)
        if err is not None or plan is None:
            err = err if err is not None else RuntimeError(
                "plan synthesis produced no plan")
            for r in waiters:
                if r.fail(err):
                    self.telemetry.count("errors")
            if not isinstance(err, Exception):
                # Genuinely fatal (KeyboardInterrupt & co): the waiters
                # are settled, now let the worker die -- and respawn.
                raise err
            return
        for i, r in enumerate(waiters):
            self._answer(r, plan, source if i == 0 else "hit",
                         exact)

    def _synthesize_best(self, req: PlanRequest):
        """The miss path: best available answer now, upgrade later."""
        scheduler = self._scheduler(req.algorithm)
        w, key = req.workload, req.key
        plan, source, exact = None, "cold", True
        family = cluster_family_key(w, req.algorithm)
        prev = self.cache.peek_family(family)
        topology_change = False
        if prev is not None and \
                prev.topo.fingerprint() != w.topo.fingerprint():
            prev = None  # same family key, different fabric: unusable
        if prev is None:
            prev = self._alias_head(family, w)
            topology_change = prev is not None
        if prev is not None and hasattr(scheduler, "try_repair_plan") and \
                prev.cluster == w.cluster:
            repair_stats: Dict = {}
            plan = scheduler.try_repair_plan(
                prev, w, fingerprint=key, config=self.repair_config,
                stats=repair_stats, topology_change=topology_change)
            if "residual_fraction" in repair_stats:
                self.telemetry.observe_repair_residual(
                    repair_stats["residual_fraction"])
            if plan is not None:
                source, exact = "warm", False
                if topology_change:
                    self.telemetry.count("rerepaired")
            else:
                self.telemetry.count("repair_tripped")
        if plan is None:
            plan, exact = scheduler.synthesize_bounded(
                w, self.synth_budget_seconds, fingerprint=key)
            if not exact:
                self.telemetry.count("degraded")
        self.telemetry.observe_synthesis(plan.synth_seconds)
        self._insert(key, plan, exact=exact)
        plan.compile()  # answers carry a ready ExecutableSchedule
        if not exact:
            self._schedule_background("upgrade", w, req.algorithm, key,
                                      stale_plan=plan)
        if self.prewarm:
            for pw in self.predictor.predict(w, req.algorithm):
                pkey = traffic_fingerprint(pw, req.algorithm)
                if self.cache.peek(pkey) is None:
                    self._schedule_background("prewarm", pw, req.algorithm,
                                              pkey)
        return plan, source, exact

    def _answer(self, req: PlanRequest, plan: Plan, source: str,
                exact: bool) -> None:
        self.telemetry.count({"hit": "hits"}.get(source, source))
        # t_start is stamped at PlanRequest construction: a request
        # without one is a bug, and reading the attribute directly makes
        # it a loud AttributeError instead of a silently-recorded ~0s
        # latency (the old getattr fallback compared perf_counter to
        # itself).
        latency = time.perf_counter() - req.t_start
        self.telemetry.observe_latency(req.tier.name, latency)
        if req.ticket is not None:
            req.ticket.resolve(PlanAnswer(
                plan=plan, source=source, exact=exact, latency_s=latency,
                request_id=req.request_id, tier=req.tier))

    def _insert(self, key: str, plan: Plan, exact: bool) -> None:
        self.cache.insert(key, plan)
        self.ttl.note_insert(key)
        with self._lock:
            if exact:
                self._inexact.discard(key)
            else:
                self._inexact.add(key)

    # -- background jobs ---------------------------------------------------

    def _schedule_background(self, kind: str, w: Workload, algorithm: str,
                             key: str,
                             stale_plan: Optional[Plan] = None) -> None:
        with self._lock:
            if key in self._background_keys:
                return
            self._background_keys.add(key)
        req = PlanRequest(workload=w, algorithm=algorithm,
                          tier=Tier.BACKGROUND, kind=kind, key=key,
                          stale_plan=stale_plan)
        try:
            self.queue.put(req)
        except (AdmissionError, ServerClosed):
            with self._lock:
                self._background_keys.discard(key)

    def _alias_head(self, family: str, w: Workload) -> Optional[Plan]:
        """Cross-fabric warm seed for a post-event miss.

        Right after a fabric event the new-fabric family has no members
        yet; the alias recorded by ``_rerepair_families`` points back at
        the pre-event family whose head is still a better starting point
        than cold synthesis."""
        with self._lock:
            old_family = self._family_alias.get(family)
        if old_family is None:
            return None
        prev = self.cache.peek_family(old_family)
        if prev is None or prev.cluster != w.cluster or \
                (prev.topo.n_servers, prev.topo.m_gpus) != (
                    w.topo.n_servers, w.topo.m_gpus):
            return None
        return prev

    def _rerepair_job(self, req: PlanRequest) -> None:
        """Re-plan one family's last traffic on the post-event fabric.

        Warm path: ``try_repair_plan(topology_change=True)`` keeps the
        old head's permutation structure and re-water-fills it against
        the new pair capacities (the quality ratchet is relaxed to
        ``TOPOLOGY_CHANGE_QUALITY_RATCHET`` -- the old structure is
        necessarily a bit off the new fabric's optimum).  Cold fallback
        only if repair trips.  The result is inserted inexact so the
        normal upgrade machinery converges it to the exact plan."""
        if self._lookup_live(req.key, counted=False) is not None:
            return  # a client miss already re-planned this family
        scheduler = self._scheduler(req.algorithm)
        prev, w = req.stale_plan, req.workload
        plan: Optional[Plan] = None
        if prev is not None and hasattr(scheduler, "try_repair_plan") and \
                prev.cluster == w.cluster:
            repair_stats: Dict = {}
            plan = scheduler.try_repair_plan(
                prev, w, fingerprint=req.key, config=self.repair_config,
                stats=repair_stats, topology_change=True)
            if "residual_fraction" in repair_stats:
                self.telemetry.observe_repair_residual(
                    repair_stats["residual_fraction"])
        exact = False
        if plan is not None:
            self.telemetry.count("rerepaired")
        else:
            plan, exact = scheduler.synthesize_bounded(
                w, self.synth_budget_seconds, fingerprint=req.key)
            self.telemetry.count("rerepair_cold")
        self.telemetry.observe_synthesis(plan.synth_seconds)
        plan.compile()
        self._insert(req.key, plan, exact=exact)
        if not exact:
            # This key is still registered in _background_keys (released
            # only after the dispatch returns); drop it first or the
            # chained upgrade would be deduplicated away.
            with self._lock:
                self._background_keys.discard(req.key)
            self._schedule_background("upgrade", w, req.algorithm,
                                      req.key, stale_plan=plan)

    def _upgrade(self, req: PlanRequest) -> None:
        """Replace a degraded cache entry with the exact plan."""
        scheduler = self._scheduler(req.algorithm)
        plan = scheduler.synthesize(req.workload, fingerprint=req.key)
        self.telemetry.observe_synthesis(plan.synth_seconds)
        plan.compile()
        self._insert(req.key, plan, exact=True)
        self.telemetry.count("upgrades")

    def _prewarm_job(self, req: PlanRequest) -> None:
        """Synthesize a predicted fingerprint ahead of demand."""
        if self._lookup_live(req.key, counted=False) is not None:
            return  # a real request beat the prediction to it
        scheduler = self._scheduler(req.algorithm)
        plan = scheduler.synthesize(req.workload, fingerprint=req.key)
        self.telemetry.observe_synthesis(plan.synth_seconds)
        plan.compile()
        self._insert(req.key, plan, exact=True)
        with self._lock:
            self._prewarmed[req.key] = None
            while len(self._prewarmed) > 1024:
                self._prewarmed.pop(next(iter(self._prewarmed)))
        self.telemetry.count("prewarmed")

    # -- queue hook --------------------------------------------------------

    def _on_shed(self, req: PlanRequest, reason: str) -> None:
        if req.kind == "plan":
            self.telemetry.count(
                "rejected" if reason == "rejected" else "shed")
        else:
            self.telemetry.count("background_shed")
            with self._lock:
                self._background_keys.discard(req.key)
