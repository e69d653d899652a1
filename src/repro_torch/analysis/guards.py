"""Guarded-state registry: which shared attributes which lock protects.

The serving layer's classes each own one mutex and a set of attributes
that must only change under it.  Before this module that mapping lived in
comments ("all mutation happens under one lock"); here it is *data* --
one ``GuardSpec`` per class -- consumed by two enforcement modes:

  * **Dynamic** (``install()``): with lock analysis enabled, every
    registered class's ``__setattr__`` is wrapped to assert that the
    instance's guard lock is held by the writing thread.  Writes during
    ``__init__`` are exempt (the object is thread-private until its
    constructor returns -- the wrapper arms itself on constructor exit),
    and enforcement only bites when the guard lock is a tracked lock
    (``locks.make_lock`` under ``REPRO_LOCK_ANALYSIS=1``), so production
    runs pay nothing.  Violations are recorded, never raised: the checker
    must not perturb the system under test.

  * **Static** (``analysis/astlint.py`` rule LCK002): a registered
    attribute assigned or mutated outside a ``with self._lock`` block --
    lexically, in the class's own methods -- is flagged at lint time,
    no execution needed.  Methods named ``*_locked`` are exempt by
    convention: they document that the caller holds the guard.

The dynamic mode sees real ``setattr`` writes (scalar counters, swapped
references); the static rule additionally covers container mutation
(``self._inflight[k] = v``, ``self._inexact.add(k)``) that never goes
through ``setattr``.  Together they close the gap.

Registry hygiene: only attributes the guard genuinely covers belong
here.  Deliberately *unregistered* shared state is documented at the
spec, e.g. ``PlanServer._dying`` (keyed by thread ident, each entry
thread-private) and config attributes assigned once before any thread
can see the object.
"""

from __future__ import annotations

import dataclasses
import functools
import importlib
import threading
from typing import Dict, List, NamedTuple, Tuple

__all__ = [
    "GuardSpec",
    "REGISTRY",
    "install",
    "uninstall",
    "installed",
    "guard_violations",
    "reset_violations",
    "specs_by_class",
    "report",
]


@dataclasses.dataclass(frozen=True)
class GuardSpec:
    """One class's concurrency contract: ``attrs`` change only under
    ``getattr(self, lock_attr)``."""

    module: str      # import path, e.g. "repro_torch.serving.server"
    cls_name: str    # class whose instances carry the state
    lock_attr: str   # attribute holding the guard lock
    attrs: Tuple[str, ...]  # attributes the lock guards


# The serving layer's shared state, one spec per class.  Mirrors the
# docstring contracts of each class; LCK002 and the dynamic checker both
# read this, so adding an attribute here immediately puts it under both
# static and runtime enforcement.
REGISTRY: Tuple[GuardSpec, ...] = (
    GuardSpec(
        "repro_torch.serving.server", "PlanServer", "_lock",
        (
            # miss coalescing, background dedup, upgrade tracking
            "_inflight", "_background_keys", "_inexact", "_prewarmed",
            # worker accounting + lifecycle flags
            "_busy", "_running", "_closed",
            # fabric-event state
            "_active_topo", "_fabric_version", "_family_alias",
        ),
        # Unregistered by design: _dying (keyed by thread ident; each
        # entry is written only by its own thread), _threads (mutated in
        # start/stop only, before workers exist / after they joined).
    ),
    GuardSpec(
        "repro_torch.serving.queue", "TieredQueue", "_lock",
        ("_count", "_closed", "_tiers"),
    ),
    GuardSpec(
        "repro_torch.serving.telemetry", "Telemetry", "_lock",
        (
            "_counters", "_latency",
            "_synth_hist", "_synth_count", "_synth_sum",
            "_repair_hist", "_repair_count", "_repair_sum",
            "_queue_depth", "_queue_peak",
            "_fabric_version", "_fabric_events", "_fabric_last",
        ),
    ),
    GuardSpec(
        "repro_torch.serving.policy", "TTLPolicy", "_lock",
        ("_born",),
    ),
    GuardSpec(
        "repro_torch.serving.policy", "DriftPredictor", "_lock",
        ("_families",),
    ),
    GuardSpec(
        "repro_torch.serving.events", "FabricMonitor", "_lock",
        ("_topology", "_version", "_subscribers", "_history"),
    ),
    GuardSpec(
        "repro_torch.core.plan", "PlanCache", "_lock",
        ("_store", "_family", "_key_family", "_family_count",
         "hits", "misses", "warm_hits"),
    ),
)


def specs_by_class() -> Dict[str, GuardSpec]:
    """Registry indexed by class name (what the AST lint keys on)."""
    return {spec.cls_name: spec for spec in REGISTRY}


class GuardViolation(NamedTuple):
    cls_name: str
    attr: str
    lock_attr: str
    thread: str
    detail: str


_state_lock = threading.Lock()  # noqa: LCK001 -- the checker's own lock
_violations: List[GuardViolation] = []
_installed: Dict[str, Tuple[type, object, object]] = {}
_ARMED_FLAG = "_repro_guards_armed"


def guard_violations() -> List[GuardViolation]:
    with _state_lock:
        return list(_violations)


def reset_violations() -> None:
    with _state_lock:
        del _violations[:]


def installed() -> bool:
    return bool(_installed)


def _record(spec: GuardSpec, attr: str) -> None:
    v = GuardViolation(
        cls_name=spec.cls_name, attr=attr, lock_attr=spec.lock_attr,
        thread=threading.current_thread().name,
        detail=(f"{spec.cls_name}.{attr} written without holding "
                f"{spec.cls_name}.{spec.lock_attr} "
                f"(thread {threading.current_thread().name!r})"),
    )
    with _state_lock:
        _violations.append(v)


def install() -> int:
    """Wrap every registered class for dynamic guarded-write checking.

    Returns the number of classes instrumented.  Idempotent; undone by
    ``uninstall``.  Only instances constructed *after* install are
    checked (the wrapper arms per-instance at constructor exit), and only
    writes where the guard lock is a tracked lock are judged -- plain
    locks carry no ownership information.
    """
    for spec in REGISTRY:
        key = f"{spec.module}.{spec.cls_name}"
        if key in _installed:
            continue
        cls = getattr(importlib.import_module(spec.module), spec.cls_name)
        orig_init = cls.__init__
        orig_setattr = cls.__setattr__
        guarded = frozenset(spec.attrs)

        def wrapped_init(self, *args, _orig=orig_init, **kwargs):
            _orig(self, *args, **kwargs)
            object.__setattr__(self, _ARMED_FLAG, True)

        def wrapped_setattr(self, name, value, _orig=orig_setattr,
                            _spec=spec, _guarded=guarded):
            if name in _guarded and getattr(self, _ARMED_FLAG, False):
                lock = getattr(self, _spec.lock_attr, None)
                held = getattr(lock, "held_by_current_thread", None)
                if held is not None and not held():
                    _record(_spec, name)
            _orig(self, name, value)

        functools.update_wrapper(wrapped_init, orig_init)
        cls.__init__ = wrapped_init
        cls.__setattr__ = wrapped_setattr
        _installed[key] = (cls, orig_init, orig_setattr)
    return len(_installed)


def uninstall() -> None:
    """Restore every class ``install`` wrapped."""
    for cls, orig_init, orig_setattr in _installed.values():
        cls.__init__ = orig_init
        cls.__setattr__ = orig_setattr
    _installed.clear()


def report() -> Dict:
    """JSON-compatible summary for the analysis runner."""
    return {
        "classes": [
            {"class": s.cls_name, "module": s.module, "lock": s.lock_attr,
             "attrs": list(s.attrs)}
            for s in REGISTRY
        ],
        "installed": installed(),
        "violations": [v._asdict() for v in guard_violations()],
    }
