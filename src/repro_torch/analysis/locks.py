"""Lock tracking: named locks, a lock-order graph, held-lock contracts.

The serving daemon's thread safety rests on about a dozen
``threading.Lock``/``RLock``/``Condition`` sites whose invariants --
"synthesis happens outside the cache lock", "the monitor notifies in
version order under its lock", "the server lock is a leaf" -- used to
live only in docstrings.  This module turns them into machine-checked
contracts:

  * Every lock in ``serving/`` and ``core/`` is created through a *named
    factory* (``make_lock``/``make_rlock``/``make_condition``).  With
    analysis off (the default) the factories return plain ``threading``
    primitives -- zero overhead, bit-for-bit the old behavior.  With
    ``REPRO_LOCK_ANALYSIS=1`` (or ``enable()``) they return tracked
    wrappers that record, per thread, the order in which named locks are
    acquired while other named locks are held.

  * The recorded edges form the process-global **lock-order graph**
    (``lock_order_edges``).  A cycle in that graph is a potential
    deadlock: two threads can interleave the cyclic acquisitions and
    block each other forever.  ``find_cycles``/``assert_acyclic`` make
    "the serving layer cannot deadlock" a test assertion instead of a
    review argument.

  * ``FORBIDDEN_WHILE_HELD`` declares which operations must never run
    while a given lock is held -- above all, no Birkhoff decomposition or
    plan synthesis inside ``PlanCache._lock`` or ``PlanServer._lock``
    (the PR-6 invariant that keeps the serving fast path microseconds).
    Instrumented entry points call ``check_forbidden("<op>")``; with
    analysis enabled, a violation is recorded (and surfaced by
    ``violations()``/``assert_clean``) the moment the contract is broken,
    with the offending lock and thread named.

Locks are tracked by *name*, not by instance: two ``PlanTicket`` locks
share the node ``"PlanTicket._lock"``.  That is deliberate -- deadlock
potential is a property of the code paths (classes), and per-instance
nodes would make the graph unbounded in a long-running daemon.  The cost
is that a genuine same-class lock nesting would appear as a self-edge;
no code path in this repo nests same-named locks, and the self-edge
would (correctly) fail ``assert_acyclic`` if one appeared.

This module imports nothing from the rest of ``repro`` so that ``core``
and ``serving`` can depend on it without cycles.
"""

from __future__ import annotations

import os
import threading
from typing import Dict, List, NamedTuple, Optional, Tuple, Union

__all__ = [
    "TrackedLock",
    "TrackedRLock",
    "make_lock",
    "make_rlock",
    "make_condition",
    "check_forbidden",
    "enabled",
    "enable",
    "disable",
    "reset",
    "lock_order_edges",
    "find_cycles",
    "assert_acyclic",
    "violations",
    "assert_clean",
    "held_locks",
    "FORBIDDEN_WHILE_HELD",
    "LockViolation",
]


# Operations that must never run while the named lock is held.  The values
# are operation tags passed to ``check_forbidden`` by the instrumented
# entry points (core/birkhoff.birkhoff_decompose, Scheduler.synthesize):
# synthesis is the expensive path the serving layer explicitly moved
# *outside* its locks, and a regression that reintroduces it under a lock
# turns every concurrent cache hit into a multi-millisecond stall.
FORBIDDEN_WHILE_HELD: Dict[str, Tuple[str, ...]] = {
    "PlanCache._lock": ("birkhoff_decompose", "synthesize"),
    "PlanServer._lock": ("birkhoff_decompose", "synthesize"),
    "TieredQueue._lock": ("birkhoff_decompose", "synthesize"),
    "FabricMonitor._lock": ("birkhoff_decompose", "synthesize"),
}


class LockViolation(NamedTuple):
    """One recorded contract violation (see ``violations``)."""

    kind: str        # "forbidden_call"
    lock: str        # the held lock whose contract was broken
    operation: str   # the operation that ran while it was held
    thread: str      # name of the offending thread
    detail: str


_ENV_FLAG = "REPRO_LOCK_ANALYSIS"

# Tri-state override: None = follow the environment variable; True/False =
# forced by enable()/disable() (tests flip this without touching os.environ).
_override: Optional[bool] = None

# All module-global analysis state hangs off one *raw* lock -- the tracker
# itself must not be tracked.
_state_lock = threading.Lock()  # noqa: LCK001 -- the tracker's own lock
_edges: Dict[Tuple[str, str], int] = {}
_violations: List[LockViolation] = []

_tls = threading.local()


def enabled() -> bool:
    """Whether newly created locks are tracked and contracts checked."""
    if _override is not None:
        return _override
    return os.environ.get(_ENV_FLAG, "") not in ("", "0")


def enable() -> None:
    """Force analysis on for locks created from now on (tests)."""
    global _override
    _override = True


def disable() -> None:
    """Force analysis off (tests); ``reset`` clears recorded state."""
    global _override
    _override = False


def reset() -> None:
    """Drop every recorded edge and violation (not the held-lock stacks)."""
    with _state_lock:
        _edges.clear()
        del _violations[:]


def _held() -> List["_TrackedBase"]:
    stack = getattr(_tls, "held", None)
    if stack is None:
        stack = _tls.held = []
    return stack


def held_locks() -> Tuple[str, ...]:
    """Names of tracked locks the *current thread* holds, outermost first."""
    return tuple(lk.name for lk in _held())


class _TrackedBase:
    """Shared bookkeeping for tracked lock wrappers.

    Wraps a real ``threading`` primitive; every successful acquire pushes
    the wrapper onto the current thread's held stack and records a
    lock-order edge from each *distinct* already-held lock name to this
    one, and every release pops it.  The wrappers satisfy the subset of
    the lock protocol ``threading.Condition`` relies on (``acquire``,
    ``release``, context manager), so a condition built over a tracked
    lock keeps the bookkeeping exact across ``wait()``'s release/reacquire
    cycle.
    """

    __slots__ = ("name", "_inner")

    def __init__(self, name: str, inner):
        self.name = name
        self._inner = inner

    # -- bookkeeping -------------------------------------------------------

    def _reentrant(self) -> bool:
        return False

    def _note_acquired(self) -> None:
        stack = _held()
        if not (self._reentrant() and any(lk is self for lk in stack)):
            seen = set()
            new_edges = []
            for lk in stack:
                if lk.name != self.name and lk.name not in seen:
                    seen.add(lk.name)
                    new_edges.append((lk.name, self.name))
            if new_edges:
                with _state_lock:
                    for e in new_edges:
                        _edges[e] = _edges.get(e, 0) + 1
        stack.append(self)

    def _note_released(self) -> None:
        stack = _held()
        # Locks are almost always released LIFO; scan from the top so the
        # common case is O(1) while out-of-order release stays correct.
        for i in range(len(stack) - 1, -1, -1):
            if stack[i] is self:
                del stack[i]
                return

    def held_by_current_thread(self) -> bool:
        return any(lk is self for lk in _held())

    # -- lock protocol -----------------------------------------------------

    def acquire(self, blocking: bool = True, timeout: float = -1) -> bool:
        ok = self._inner.acquire(blocking, timeout)
        if ok:
            self._note_acquired()
        return ok

    def release(self) -> None:
        self._note_released()
        self._inner.release()

    def __enter__(self) -> bool:
        return self.acquire()

    def __exit__(self, *exc) -> None:
        self.release()

    def __repr__(self) -> str:
        return f"<{type(self).__name__} {self.name!r} at {id(self):#x}>"


class TrackedLock(_TrackedBase):
    """Named, order-tracked ``threading.Lock`` (``make_lock``)."""

    __slots__ = ()

    def __init__(self, name: str):
        super().__init__(name, threading.Lock())  # noqa: LCK001 -- wrapped

    def locked(self) -> bool:
        return self._inner.locked()


class TrackedRLock(_TrackedBase):
    """Named, order-tracked ``threading.RLock`` (``make_rlock``).

    Reentrant re-acquisitions by the owning thread record no edges -- a
    lock cannot deadlock against itself through legitimate reentrancy.
    """

    __slots__ = ()

    def __init__(self, name: str):
        super().__init__(name, threading.RLock())  # noqa: LCK001 -- wrapped

    def _reentrant(self) -> bool:
        return True

    # threading.Condition uses these when handed an RLock-like object, so
    # a condition over a tracked RLock stays bookkeeping-exact.
    def _is_owned(self) -> bool:
        return self.held_by_current_thread()

    def _release_save(self):
        saved = self._inner._release_save()
        # The full recursion count was released in one call: drop every
        # stack entry for this lock.
        stack = _held()
        stack[:] = [lk for lk in stack if lk is not self]
        return saved

    def _acquire_restore(self, saved) -> None:
        self._inner._acquire_restore(saved)
        self._note_acquired()


def make_lock(name: str) -> Union[threading.Lock, TrackedLock]:
    """A mutex named for analysis: plain ``threading.Lock`` unless lock
    analysis is enabled (``REPRO_LOCK_ANALYSIS=1`` / ``enable()``), then a
    ``TrackedLock`` feeding the lock-order graph.  Name by owning class
    and attribute, e.g. ``"PlanCache._lock"``."""
    if enabled():
        return TrackedLock(name)
    return threading.Lock()  # noqa: LCK001 -- the factory itself


def make_rlock(name: str) -> Union[threading.RLock, TrackedRLock]:
    """``make_lock`` for reentrant locks."""
    if enabled():
        return TrackedRLock(name)
    return threading.RLock()  # noqa: LCK001 -- the factory itself


def make_condition(name: str, lock=None) -> threading.Condition:
    """A condition variable over a (tracked when enabled) named lock.

    Pass ``lock`` to share an existing factory-made lock (the TieredQueue
    pattern: one mutex, one condition); otherwise a fresh one named
    ``name`` is created.  The returned object is always a genuine
    ``threading.Condition`` -- over the tracked wrapper when analysis is
    on, so waits and notifications keep the held-lock bookkeeping exact.
    """
    if lock is None:
        lock = make_lock(name)
    return threading.Condition(lock)  # noqa: LCK001 -- the factory itself


def check_forbidden(operation: str) -> None:
    """Record a violation if ``operation`` runs under a forbidding lock.

    Instrumented entry points (``birkhoff_decompose``, ``synthesize``)
    call this unconditionally; with analysis disabled it is a single flag
    check.  Violations are recorded, not raised: the contract check must
    never alter control flow of the system under test -- tests assert via
    ``violations()``/``assert_clean`` afterwards.
    """
    if not enabled():
        return
    held = _held()
    if not held:
        return
    for lk in held:
        forbidden = FORBIDDEN_WHILE_HELD.get(lk.name, ())
        if operation in forbidden:
            v = LockViolation(
                kind="forbidden_call",
                lock=lk.name,
                operation=operation,
                thread=threading.current_thread().name,
                detail=(f"{operation!r} ran while {lk.name!r} was held "
                        f"(held stack: {list(held_locks())})"),
            )
            with _state_lock:
                _violations.append(v)


# -- reporting -------------------------------------------------------------

def lock_order_edges() -> Dict[Tuple[str, str], int]:
    """Copy of the recorded lock-order graph: (held, acquired) -> count."""
    with _state_lock:
        return dict(_edges)


def find_cycles() -> List[List[str]]:
    """Every elementary cycle-witness in the lock-order graph.

    Returns one representative path per back edge found by iterative DFS
    (``[a, b, ..., a]``); empty means the acquisition order is a partial
    order and the tracked locks cannot deadlock among themselves.
    """
    graph: Dict[str, List[str]] = {}
    for (a, b) in lock_order_edges():
        graph.setdefault(a, []).append(b)
        graph.setdefault(b, [])
    cycles: List[List[str]] = []
    color: Dict[str, int] = {}  # 0/absent = white, 1 = on stack, 2 = done
    for root in sorted(graph):
        if color.get(root):
            continue
        path: List[str] = []
        stack: List[Tuple[str, int]] = [(root, 0)]
        while stack:
            node, idx = stack.pop()
            if idx == 0:
                color[node] = 1
                path.append(node)
            nbrs = graph[node]
            advanced = False
            for j in range(idx, len(nbrs)):
                nxt = nbrs[j]
                c = color.get(nxt, 0)
                if c == 1:
                    cycles.append(path[path.index(nxt):] + [nxt])
                elif c == 0:
                    stack.append((node, j + 1))
                    stack.append((nxt, 0))
                    advanced = True
                    break
            if not advanced:
                color[node] = 2
                path.pop()
    return cycles


def assert_acyclic() -> None:
    """Raise ``AssertionError`` naming the cycle if the graph has one."""
    cycles = find_cycles()
    if cycles:
        raise AssertionError(
            f"lock-order graph has {len(cycles)} cycle(s) -- potential "
            f"deadlock: {cycles}")


def violations() -> List[LockViolation]:
    with _state_lock:
        return list(_violations)


def assert_clean() -> None:
    """Acyclic graph *and* zero contract violations, or AssertionError."""
    assert_acyclic()
    vs = violations()
    if vs:
        raise AssertionError(
            f"{len(vs)} lock-contract violation(s): "
            + "; ".join(v.detail for v in vs))


def report() -> Dict:
    """JSON-compatible summary for the analysis runner."""
    return {
        "enabled": enabled(),
        "edges": [{"held": a, "acquired": b, "count": c}
                  for (a, b), c in sorted(lock_order_edges().items())],
        "cycles": find_cycles(),
        "violations": [v._asdict() for v in violations()],
    }
