"""Fabric events: topology change as a first-class serving scenario.

Real two-tier fabrics shift *under* the traffic -- NICs fail, links run
degraded, servers recover -- and before this module a fabric change was
only handled implicitly: a new topology fingerprint meant every warm plan
family went cold at once, so a single NIC failure turned into a wall of
cold syntheses exactly when the fabric had the least capacity to spare.

``FabricEvent`` names the change (degrade / fail / recover, NIC- or
server-scoped, optionally direction-split for asymmetric up/down rates)
and ``FabricMonitor`` serializes events into a monotonically versioned
stream: it owns the authoritative current ``Topology``, applies each
injected event through the scenario constructors
(``degrade_nic``/``fail_nic``/``degrade_server``/``recover_nic``/...),
and notifies subscribers -- above all ``PlanServer.apply_fabric_event``,
which swaps its active fabric and re-repairs every affected plan family
against the new pair capacities instead of evicting them (see
DESIGN.md, "Fault tolerance and fabric events").

Versioning makes delivery idempotent and reorder-safe: each event carries
the monotone version stamped at injection, and a consumer simply ignores
any event at or below the version it has already applied.
"""

from __future__ import annotations

import dataclasses
from typing import Any, Callable, Dict, List, Optional, Tuple

from ..analysis.locks import make_lock
from ..core.topology import Topology

__all__ = [
    "FabricEvent",
    "FabricMonitor",
]

_KINDS = ("degrade", "fail", "recover")
_DIRECTIONS = ("both", "up", "down")


@dataclasses.dataclass(frozen=True)
class FabricEvent:
    """One observed fabric change.

    Attributes:
      kind: ``"degrade"`` (a link running slow), ``"fail"`` (degrade to
        zero) or ``"recover"`` (back to the pre-degradation rate).
      server: the affected server index.
      nic: the affected NIC (rail) index, or None for a server-scoped
        event (every NIC of the server).
      factor: for ``degrade``, the fraction of nominal speed in [0, 1];
        ignored for ``fail`` (0) and ``recover``.
      direction: which plane the event hits -- ``"both"`` (default),
        ``"up"`` (transmit only) or ``"down"`` (receive only), for
        asymmetric up/down degradation.  Recovery always restores both
        planes.
      version: monotone sequence number, stamped by the ``FabricMonitor``
        at injection (0 = unstamped).  Consumers apply events in version
        order and drop anything at or below their last applied version.
    """

    kind: str
    server: int
    nic: Optional[int] = None
    factor: float = 1.0
    direction: str = "both"
    version: int = 0

    def __post_init__(self):
        if self.kind not in _KINDS:
            raise ValueError(f"kind must be one of {_KINDS}, "
                             f"got {self.kind!r}")
        if self.direction not in _DIRECTIONS:
            raise ValueError(f"direction must be one of {_DIRECTIONS}, "
                             f"got {self.direction!r}")
        if self.kind == "degrade" and not 0.0 <= self.factor <= 1.0:
            raise ValueError(
                f"degrade factor must be in [0, 1], got {self.factor}")

    def apply(self, topo: Topology) -> Topology:
        """The topology after this event (pure; ``topo`` is unchanged)."""
        if self.kind == "recover":
            if self.nic is None:
                return topo.recover_server(self.server)
            return topo.recover_nic(self.server, self.nic)
        factor = 0.0 if self.kind == "fail" else self.factor
        if self.nic is None:
            return topo.degrade_server(self.server, factor, self.direction)
        return topo.degrade_nic(self.server, self.nic, factor,
                                self.direction)

    def describe(self) -> str:
        scope = (f"server {self.server}" if self.nic is None
                 else f"nic {self.server}.{self.nic}")
        extra = f" x{self.factor:g}" if self.kind == "degrade" else ""
        plane = "" if self.direction == "both" else f" [{self.direction}]"
        return f"v{self.version} {self.kind} {scope}{extra}{plane}"

    def to_dict(self) -> Dict[str, Any]:
        return dataclasses.asdict(self)


class FabricMonitor:
    """Serializes fabric events and owns the authoritative live topology.

    In production the inject() calls would be fed by a health prober
    (NIC counters, link-flap interrupts); here injection is explicit so
    examples, benchmarks and tests can script failure timelines.

    Subscribers receive ``(event, new_topology)`` strictly in version
    order -- notification happens under the monitor lock, so no
    subscriber can observe version k+1 before k.  Subscriber exceptions
    propagate to the injector: a fabric event a consumer failed to apply
    is an operational error the caller must see, not swallow.
    """

    def __init__(self, topology: Topology):
        self._lock = make_lock("FabricMonitor._lock")
        self._topology = topology
        self._version = 0
        self._subscribers: List[Callable[[FabricEvent, Topology], None]] = []
        self._history: List[FabricEvent] = []

    @property
    def version(self) -> int:
        with self._lock:
            return self._version

    def current(self) -> Topology:
        """The live topology after every injected event."""
        with self._lock:
            return self._topology

    def snapshot(self) -> Tuple[int, Topology]:
        """``(version, topology)`` from one critical section -- the two
        reads cannot tear across a concurrent ``inject``.  Consumers
        adopting the fabric (``PlanServer.attach_monitor``) use this so
        they never hold their own lock while reading the monitor (the
        monitor notifies *them* under its lock; nesting the other way
        would close a lock-order cycle)."""
        with self._lock:
            return self._version, self._topology

    def history(self) -> List[FabricEvent]:
        with self._lock:
            return list(self._history)

    def subscribe(self, fn: Callable[[FabricEvent, Topology], None],
                  ) -> None:
        """Register a consumer; it is NOT replayed past events (read
        ``current()`` at attach time instead, like PlanServer does)."""
        with self._lock:
            self._subscribers.append(fn)

    def inject(self, kind: str, server: int, nic: Optional[int] = None, *,
               factor: float = 1.0,
               direction: str = "both") -> FabricEvent:
        """Apply one fabric change: stamp the next version, advance the
        live topology, notify subscribers.  Returns the stamped event."""
        with self._lock:
            event = FabricEvent(kind=kind, server=server, nic=nic,
                                factor=factor, direction=direction,
                                version=self._version + 1)
            new_topo = event.apply(self._topology)
            self._version = event.version
            self._topology = new_topo
            self._history.append(event)
            subscribers = list(self._subscribers)
            for fn in subscribers:
                fn(event, new_topo)
        return event
