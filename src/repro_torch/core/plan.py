"""Scheduler-agnostic Plan IR: the contract between synthesis and execution.

A ``Plan`` is a typed, ordered sequence of phases describing *what moves
where, under which concurrency semantics* -- with no timing model attached.
Schedulers (schedulers.py) synthesize Plans; the single generic alpha-beta
executor (simulator.py) times them.  Incast and straggler effects are
properties of *stage types*, not algorithm names:

  * ``PermutationStage``  -- one sender per receiver, equal chunk size
                             (incast-free, straggler-free; FLASH/Birkhoff).
                             Consecutive permutation stages pipeline: stage
                             k's intra redistribute hides under stage k+1's
                             inter transfer (paper Theorem 2).
  * ``BarrierStage``      -- a barrier-synchronized set of point-to-point
                             flows; the stage waits for its slowest flow
                             (the straggler effect; MPI SpreadOut).
  * ``FanOutBurst``       -- everything at once; NICs fair-share and incast
                             collapse beyond buffer absorption (RCCL FanOut).
  * ``RailStage``         -- rail-aligned NIC loads progressing in rotation
                             rounds (MSCCL-style hierarchical).
  * ``BoundStage``        -- analytic Theorem-1 bound (the 'optimal' line;
                             not executable on hardware, timeable here).

Pre/post phases: ``LoadBalancePhase`` (intra-server shedding before the
inter phase), ``RedistributePhase`` (the un-hidden pipeline tail) and
``IntraOverlapPhase`` (local traffic overlapped with the inter phase).

Every phase serializes to plain JSON-compatible dicts (``to_dict`` /
``from_dict`` via the ``PHASE_KINDS`` registry) and reports the genuine
payload bytes it carries so ``Plan.validate`` can check byte conservation
against the source workload.

``PlanCache`` keys synthesized plans by a traffic-matrix fingerprint --
the paper's dynamic-MoE reuse story: expert routing shifts every few
hundred milliseconds but frequently *repeats* signatures across iterations,
so re-synthesis can be skipped when the fingerprint hits (hit/miss counters
exposed).  See DESIGN.md section 1.
"""

from __future__ import annotations

import dataclasses
import hashlib
from collections import OrderedDict
from typing import Any, ClassVar, Dict, List, Optional, Tuple

import numpy as np

from ..analysis.locks import make_rlock
from .birkhoff import live_slots, live_slots_batch
from .topology import Topology, uniform_nic_shares
from .traffic import ClusterSpec, Workload, server_reduce

__all__ = [
    "Plan",
    "PlanValidationError",
    "PlanCache",
    "traffic_fingerprint",
    "cluster_family_key",
    "plan_family_key",
    "LoadBalancePhase",
    "PermutationStage",
    "PermutationBlock",
    "BarrierStage",
    "FanOutBurst",
    "RailStage",
    "BoundStage",
    "RedistributePhase",
    "IntraOverlapPhase",
    "PHASE_KINDS",
]


class PlanValidationError(ValueError):
    """A Plan fails structural or byte-conservation checks."""


# kind string -> phase class, for from_dict round-tripping.
PHASE_KINDS: Dict[str, type] = {}


def register_phase(cls):
    PHASE_KINDS[cls.kind] = cls
    return cls


def _np2d(v) -> np.ndarray:
    return np.asarray(v, dtype=np.float64)


def _listify(a: np.ndarray):
    return np.asarray(a, dtype=np.float64).tolist()


@dataclasses.dataclass(frozen=True, eq=False)
class PhaseBase:
    """Common serialization + payload-accounting interface.

    ``payload(cluster)`` returns ``(inter_bytes, intra_bytes)`` of *genuine
    workload payload* this phase carries across the inter-server network and
    the intra-server fabric respectively.  Auxiliary movement (load-balance
    shedding, redistribute copies) reports (0, 0): it is overhead the
    schedule added, not workload bytes, so it is excluded from conservation.
    """

    kind: ClassVar[str] = "base"

    def payload(self, cluster: ClusterSpec) -> Tuple[float, float]:
        return 0.0, 0.0

    def to_dict(self) -> Dict[str, Any]:
        raise NotImplementedError

    @classmethod
    def from_dict(cls, d: Dict[str, Any]) -> "PhaseBase":
        raise NotImplementedError


@register_phase
@dataclasses.dataclass(frozen=True, eq=False)
class LoadBalancePhase(PhaseBase):
    """Intra-server head phase: each GPU sheds ``moved_per_gpu`` bytes over
    the intra fabric before the inter phase starts (FLASH load balance /
    hierarchical rail gather).  Auxiliary movement: not payload."""

    kind: ClassVar[str] = "load_balance"
    moved_per_gpu: np.ndarray  # (n_servers, m_gpus)
    charge_alpha: bool = True  # FLASH charges a wakeup; rail gather does not

    def to_dict(self):
        return {"kind": self.kind,
                "moved_per_gpu": _listify(self.moved_per_gpu),
                "charge_alpha": bool(self.charge_alpha)}

    @classmethod
    def from_dict(cls, d):
        return cls(moved_per_gpu=_np2d(d["moved_per_gpu"]),
                   charge_alpha=bool(d["charge_alpha"]))


@register_phase
@dataclasses.dataclass(frozen=True, eq=False)
class PermutationStage(PhaseBase):
    """One incast-free, straggler-free inter-server stage: server i sends a
    ``size``-byte slot to server ``perm[i]`` (-1 = idle padding slot);
    ``sent[i]`` is the genuine payload inside the slot.

    ``slots`` is None for capacity-blind stages (uniform ``size``-byte
    slots).  Capacity-aware synthesis sizes each sender's slot to its pair
    capacity (``slots[i] = window * pair_capacity(i, perm[i])``) so every
    pair drains in the same time window -- equal-*time* slots, the
    heterogeneous-fabric generalization of straggler freedom; ``size`` is
    then the largest slot.
    """

    kind: ClassVar[str] = "permutation"
    perm: Tuple[int, ...]
    size: float
    sent: Tuple[float, ...]
    slots: Optional[Tuple[float, ...]] = None

    def payload(self, cluster):
        return float(sum(self.sent)), 0.0

    @property
    def real_bytes(self) -> float:
        return float(sum(self.sent))

    def live(self) -> Tuple[np.ndarray, np.ndarray, np.ndarray]:
        """Memoized ``live_slots`` of this stage: ``(src, dst, slot)``.

        The interpreted executor consults a stage's live senders up to
        three times (transfer, hidden redistribute, pipeline tail) and the
        validator once more; the stage is frozen, so the extraction is
        computed once and shared.  The arrays are read-only."""
        cached = self.__dict__.get("_live")
        if cached is None:
            cached = live_slots(self.perm, self.slots, self.size)
            for a in cached:
                a.flags.writeable = False
            object.__setattr__(self, "_live", cached)
        return cached

    def to_dict(self):
        d = {"kind": self.kind, "perm": list(self.perm),
             "size": float(self.size), "sent": list(self.sent)}
        if self.slots is not None:
            d["slots"] = list(self.slots)
        return d

    @classmethod
    def from_dict(cls, d):
        slots = d.get("slots")
        return cls(perm=tuple(int(j) for j in d["perm"]),
                   size=float(d["size"]),
                   sent=tuple(float(x) for x in d["sent"]),
                   slots=None if slots is None
                   else tuple(float(x) for x in slots))


@register_phase
@dataclasses.dataclass(frozen=True, eq=False)
class PermutationBlock(PhaseBase):
    """A run of consecutive permutation stages carried as stacked arrays.

    Semantically identical to emitting ``len(sizes)`` PermutationStages in
    order -- same pipelining, same slot rules -- but the incremental
    trajectory engine (birkhoff.DecompositionState) re-emits ~n^2 stages
    per drift step, and materializing that many per-stage objects costs
    more than the decomposition delta itself.  ``perms`` is (S, n) with -1
    for idle senders, ``sizes`` (S,), ``sent`` (S, n) genuine payload
    bytes, and ``slots`` either None (capacity-blind: uniform ``size``-byte
    slots) or (S, n) per-sender slot bytes (capacity-aware).
    """

    kind: ClassVar[str] = "permutation_block"
    perms: np.ndarray
    sizes: np.ndarray
    sent: np.ndarray
    slots: Optional[np.ndarray] = None

    @property
    def n_stages(self) -> int:
        return int(self.sizes.shape[0])

    def payload(self, cluster):
        return float(self.sent.sum()), 0.0

    @property
    def real_bytes(self) -> float:
        return float(self.sent.sum())

    def slot2d(self) -> np.ndarray:
        """(S, n) per-sender slot bytes; blind rows broadcast the size."""
        if self.slots is not None:
            return np.asarray(self.slots, dtype=np.float64)
        return np.broadcast_to(
            np.asarray(self.sizes, dtype=np.float64)[:, None],
            self.perms.shape)

    def live_batch(self) -> Tuple[np.ndarray, np.ndarray, np.ndarray]:
        """Memoized ``live_slots_batch``: ``(mask, dst, slot)`` over all S
        stages -- the compiled executor's and validator's shared view."""
        cached = self.__dict__.get("_live_batch")
        if cached is None:
            cached = live_slots_batch(self.perms, self.slot2d())
            for a in cached:
                a.flags.writeable = False
            object.__setattr__(self, "_live_batch", cached)
        return cached

    def stage_view(self, k: int) -> PermutationStage:
        """Stage ``k`` as an equivalent PermutationStage (interop paths:
        the interpreted executor, FlashPlan export, the pipeline tail)."""
        return PermutationStage(
            perm=tuple(int(j) for j in self.perms[k]),
            size=float(self.sizes[k]),
            sent=tuple(float(x) for x in self.sent[k]),
            slots=None if self.slots is None
            else tuple(float(x) for x in self.slots[k]))

    def iter_stages(self):
        return (self.stage_view(k) for k in range(self.n_stages))

    def to_dict(self):
        d = {"kind": self.kind,
             "perms": [[int(j) for j in row] for row in self.perms],
             "sizes": _listify(self.sizes),
             "sent": [_listify(row) for row in self.sent]}
        if self.slots is not None:
            d["slots"] = [_listify(row) for row in self.slots]
        return d

    @classmethod
    def from_dict(cls, d):
        slots = d.get("slots")
        return cls(perms=np.asarray(d["perms"], dtype=np.int64),
                   sizes=_np2d(d["sizes"]),
                   sent=_np2d(d["sent"]),
                   slots=None if slots is None else _np2d(slots))


@register_phase
@dataclasses.dataclass(frozen=True, eq=False)
class BarrierStage(PhaseBase):
    """Barrier-synchronized flow set: GPU g sends ``sizes[g]`` bytes to GPU
    ``dsts[g]``; the stage completes when the slowest flow does."""

    kind: ClassVar[str] = "barrier"
    sizes: np.ndarray  # (n_gpus,)
    dsts: np.ndarray   # (n_gpus,) destination GPU index per source GPU

    def _same_server(self, cluster: ClusterSpec) -> np.ndarray:
        m = cluster.m_gpus
        src = np.arange(len(self.sizes))
        return (src // m) == (self.dsts.astype(np.int64) // m)

    def payload(self, cluster):
        same = self._same_server(cluster)
        return (float(self.sizes[~same].sum()),
                float(self.sizes[same].sum()))

    def to_dict(self):
        return {"kind": self.kind, "sizes": _listify(self.sizes),
                "dsts": [int(j) for j in self.dsts]}

    @classmethod
    def from_dict(cls, d):
        return cls(sizes=_np2d(d["sizes"]),
                   dsts=np.asarray(d["dsts"], dtype=np.int64))


@register_phase
@dataclasses.dataclass(frozen=True, eq=False)
class FanOutBurst(PhaseBase):
    """All flows of a GPU-level matrix launched at once: receiver NICs
    fair-share and collapse under incast; intra-server traffic rides the
    fast fabric concurrently."""

    kind: ClassVar[str] = "fanout_burst"
    matrix: np.ndarray  # (n_gpus, n_gpus)

    def payload(self, cluster):
        n, m = cluster.n_servers, cluster.m_gpus
        blk = self.matrix.reshape(n, m, n, m)
        intra = float(sum(blk[a, :, a, :].sum() for a in range(n)))
        return float(self.matrix.sum()) - intra, intra

    def to_dict(self):
        return {"kind": self.kind, "matrix": _listify(self.matrix)}

    @classmethod
    def from_dict(cls, d):
        return cls(matrix=_np2d(d["matrix"]))


@register_phase
@dataclasses.dataclass(frozen=True, eq=False)
class RailStage(PhaseBase):
    """Rail-aligned inter-server phase: NIC i of server a carries
    ``send[a, i]`` outbound / ``recv[a, i]`` inbound bytes, progressing in
    ``n_rounds`` rotation rounds (one wakeup each).  The max-loaded rail is
    the straggler."""

    kind: ClassVar[str] = "rail"
    send: np.ndarray  # (n_servers, m_gpus)
    recv: np.ndarray  # (n_servers, m_gpus)
    n_rounds: int

    def payload(self, cluster):
        return float(self.send.sum()), 0.0

    def to_dict(self):
        return {"kind": self.kind, "send": _listify(self.send),
                "recv": _listify(self.recv), "n_rounds": int(self.n_rounds)}

    @classmethod
    def from_dict(cls, d):
        return cls(send=_np2d(d["send"]), recv=_np2d(d["recv"]),
                   n_rounds=int(d["n_rounds"]))


@register_phase
@dataclasses.dataclass(frozen=True, eq=False)
class BoundStage(PhaseBase):
    """Analytic Theorem-1 phase: ``bound_bytes`` (the max line sum of the
    server matrix) crossing the aggregate per-server NIC bandwidth.
    ``inter_total`` records the genuine inter-server bytes represented."""

    kind: ClassVar[str] = "bound"
    bound_bytes: float
    inter_total: float
    # Per-server max(row, col) line sums; lets the link-level executor bound
    # each server against its own aggregate NIC capacity (heterogeneous
    # fabrics).  None = legacy scalar form.
    line_sums: Optional[Tuple[float, ...]] = None

    def payload(self, cluster):
        return float(self.inter_total), 0.0

    def to_dict(self):
        d = {"kind": self.kind, "bound_bytes": float(self.bound_bytes),
             "inter_total": float(self.inter_total)}
        if self.line_sums is not None:
            d["line_sums"] = [float(x) for x in self.line_sums]
        return d

    @classmethod
    def from_dict(cls, d):
        ls = d.get("line_sums")
        return cls(bound_bytes=float(d["bound_bytes"]),
                   inter_total=float(d["inter_total"]),
                   line_sums=None if ls is None else
                   tuple(float(x) for x in ls))


@register_phase
@dataclasses.dataclass(frozen=True, eq=False)
class RedistributePhase(PhaseBase):
    """Pipeline-tail intra phase: ``bytes_per_gpu`` bytes per GPU moved over
    the intra fabric after the last inter stage (auxiliary movement)."""

    kind: ClassVar[str] = "redistribute"
    bytes_per_gpu: float
    charge_alpha: bool = True

    def to_dict(self):
        return {"kind": self.kind, "bytes_per_gpu": float(self.bytes_per_gpu),
                "charge_alpha": bool(self.charge_alpha)}

    @classmethod
    def from_dict(cls, d):
        return cls(bytes_per_gpu=float(d["bytes_per_gpu"]),
                   charge_alpha=bool(d["charge_alpha"]))


@register_phase
@dataclasses.dataclass(frozen=True, eq=False)
class IntraOverlapPhase(PhaseBase):
    """Per-server local traffic S_i spread over the server's intra fabric,
    overlapped with the inter phase: only the residual beyond the inter
    phase's duration is charged."""

    kind: ClassVar[str] = "intra_overlap"
    per_server: np.ndarray  # (n_servers,) S_i bytes

    def payload(self, cluster):
        return 0.0, float(self.per_server.sum())

    def to_dict(self):
        return {"kind": self.kind, "per_server": _listify(self.per_server)}

    @classmethod
    def from_dict(cls, d):
        return cls(per_server=_np2d(d["per_server"]))


@dataclasses.dataclass(frozen=True, eq=False)
class Plan:
    """A synthesized All-to-All schedule, decoupled from any timing model.

    Attributes:
      algorithm: registry name of the scheduler that produced this plan.
      cluster: the two-tier cluster the plan targets (scalar shape view).
      phases: ordered typed phases (see module docstring).
      synth_seconds: wall-clock schedule-synthesis time (paper Fig 17a).
      extra_memory_bytes: staging buffers beyond the universal 2x send/recv
        footprint (FLASH's load-balance + redistribute staging, Fig 17b).
      accounts_intra: whether this plan explicitly schedules the workload's
        intra-server bytes (validate() only checks intra conservation then).
      fingerprint: traffic-matrix fingerprint of the source workload
        (includes the topology fingerprint).
      topology: the link-level fabric this plan was synthesized for; None
        means "the homogeneous fabric derived from ``cluster``" (``topo``
        resolves it).  Executing a plan on a *different* fabric than it was
        synthesized for is a deliberate topology-blindness experiment --
        pass the override to ``execute_plan``.
      nic_shares: optional (n_servers, n_servers, m_gpus) per-rail fraction
        of each (src, dst) server pair's slot bytes, fixed at synthesis
        time (FLASH's capacity-proportional rebalance target; rail g of a
        pair is capped by the slower endpoint NIC).  None = uniform 1/m.
      capacity_aware: provenance flag -- the permutation stages were
        synthesized against the topology's pair capacities (per-sender
        ``slots`` sized to drain in a common window).  ``validate()`` then
        additionally checks slot-vs-rail feasibility: no rail of any live
        pair may need longer than the stage's window to drain its share.
    """

    algorithm: str
    cluster: ClusterSpec
    phases: Tuple[PhaseBase, ...]
    synth_seconds: float = 0.0
    extra_memory_bytes: float = 0.0
    accounts_intra: bool = True
    fingerprint: Optional[str] = None
    topology: Optional[Topology] = None
    nic_shares: Optional[np.ndarray] = None
    capacity_aware: bool = False

    @property
    def topo(self) -> Topology:
        """The fabric the plan was synthesized for (derived when None).

        Memoized like ``Workload.topo``: validation, execution and cache
        keying all consult it, and the derived instance carries the
        memoized ``fingerprint()``."""
        if self.topology is not None:
            return self.topology
        derived = self.__dict__.get("_derived_topo")
        if derived is None:
            derived = Topology.from_cluster(self.cluster)
            object.__setattr__(self, "_derived_topo", derived)
        return derived

    def compile(self, topology: Optional[Topology] = None):
        """Compile this plan for repeated execution: an ExecutableSchedule.

        The compiler (``simulator.compile_plan``) flattens every phase
        into padded array form and times the whole plan in one vectorized
        pass; the result answers ``execute(w)`` / ``execute_batch(stack)``
        with no per-stage Python at all.  Compiled schedules are memoized
        on the plan per *execution-topology* fingerprint -- the compiled
        cache slot that rides along with the Plan inside a ``PlanCache``,
        so a cache hit skips synthesis *and* compilation, and a topology
        change (new fingerprint) transparently recompiles instead of
        serving stale link capacities.
        """
        from .simulator import compile_plan

        topo = topology if topology is not None else self.topo
        memo = self.__dict__.get("_compiled")
        if memo is None:
            memo = {}
            object.__setattr__(self, "_compiled", memo)
        key = topo.fingerprint()
        sched = memo.get(key)
        if sched is None:
            sched = compile_plan(self, topology=topo)
            if len(memo) >= 8:  # serving loops see 1-2 fabrics per plan
                memo.clear()
            memo[key] = sched
        return sched

    def iter_perm_stages(self):
        """Every inter-server permutation in execution order, as tuples.

        The device-lowering view consumed by ``comm.plan_exec.lower_plan``:
        ``perm[i]`` is server ``i``'s send target this stage (-1 = idle).
        Only PermutationStage / PermutationBlock phases carry an explicit
        static permutation; other stage kinds (FanOutBurst, RailStage,
        BoundStage) yield nothing here and are covered by the lowering's
        fallback rotations instead.
        """
        for p in self.phases:
            if isinstance(p, PermutationStage):
                yield tuple(int(j) for j in p.perm)
            elif isinstance(p, PermutationBlock):
                for row in p.perms:
                    yield tuple(int(j) for j in row)

    @property
    def stages(self) -> Tuple[PhaseBase, ...]:
        """The inter-server stage phases, in execution order."""
        return tuple(p for p in self.phases if isinstance(
            p, (PermutationStage, PermutationBlock, BarrierStage,
                FanOutBurst, RailStage, BoundStage)))

    @property
    def n_stages(self) -> int:
        total = 0
        for p in self.stages:
            if isinstance(p, RailStage):
                total += p.n_rounds
            elif isinstance(p, PermutationBlock):
                total += p.n_stages
            else:
                total += 1
        return total

    @property
    def inter_bytes(self) -> float:
        """Genuine payload bytes crossing the inter-server network."""
        return float(sum(p.payload(self.cluster)[0] for p in self.phases))

    # -- serialization --------------------------------------------------

    def to_dict(self) -> Dict[str, Any]:
        return {
            "algorithm": self.algorithm,
            "cluster": dataclasses.asdict(self.cluster),
            "phases": [p.to_dict() for p in self.phases],
            "synth_seconds": float(self.synth_seconds),
            "extra_memory_bytes": float(self.extra_memory_bytes),
            "accounts_intra": bool(self.accounts_intra),
            "fingerprint": self.fingerprint,
            "topology": None if self.topology is None
            else self.topology.to_dict(),
            "nic_shares": None if self.nic_shares is None
            else _listify(self.nic_shares),
            "capacity_aware": bool(self.capacity_aware),
        }

    @classmethod
    def from_dict(cls, d: Dict[str, Any]) -> "Plan":
        phases = []
        for pd in d["phases"]:
            try:
                phase_cls = PHASE_KINDS[pd["kind"]]
            except KeyError:
                raise PlanValidationError(
                    f"unknown phase kind {pd['kind']!r}; known: "
                    f"{sorted(PHASE_KINDS)}")
            phases.append(phase_cls.from_dict(pd))
        return cls(
            algorithm=d["algorithm"],
            cluster=ClusterSpec(**d["cluster"]),
            phases=tuple(phases),
            synth_seconds=float(d["synth_seconds"]),
            extra_memory_bytes=float(d["extra_memory_bytes"]),
            accounts_intra=bool(d["accounts_intra"]),
            fingerprint=d.get("fingerprint"),
            topology=Topology.from_dict(d.get("topology")),
            nic_shares=None if d.get("nic_shares") is None
            else _np2d(d["nic_shares"]),
            capacity_aware=bool(d.get("capacity_aware", False)),
        )

    # -- validation -----------------------------------------------------

    def validate(self, w: Workload, rtol: float = 1e-6) -> None:
        """Check structure and byte conservation against the workload.

        Raises PlanValidationError if the plan's inter-server stages do not
        collectively carry exactly the workload's inter-server bytes (and,
        when ``accounts_intra``, its intra-server bytes too), or if any
        permutation stage has incast (two senders per receiver) or
        self-traffic.
        """
        if w.cluster != self.cluster:
            raise PlanValidationError(
                f"plan targets {self.cluster}, workload runs on {w.cluster}")
        if self.topo.fingerprint() != w.topo.fingerprint():
            raise PlanValidationError(
                "plan was synthesized for a different topology than the "
                "workload's fabric (stale plan?); re-synthesize or pass an "
                "explicit execution-topology override to execute_plan")
        self.validate_structure(rtol)

        t_server, s_intra = server_reduce(w.matrix, self.cluster.m_gpus)
        inter_expected = float(t_server.sum())
        intra_expected = float(s_intra.sum())
        inter_carried = 0.0
        intra_carried = 0.0
        for p in self.phases:
            i, s = p.payload(self.cluster)
            inter_carried += i
            intra_carried += s

        scale = max(inter_expected, intra_expected, 1.0)
        if abs(inter_carried - inter_expected) > rtol * scale:
            raise PlanValidationError(
                f"inter-server bytes not conserved: plan carries "
                f"{inter_carried:.6g}, workload has {inter_expected:.6g}")
        if self.accounts_intra and \
                abs(intra_carried - intra_expected) > rtol * scale:
            raise PlanValidationError(
                f"intra-server bytes not conserved: plan carries "
                f"{intra_carried:.6g}, workload has {intra_expected:.6g}")

    def validate_structure(self, rtol: float = 1e-6) -> None:
        """Workload-independent structural checks.

        Everything ``validate`` can prove without the source traffic
        matrix: permutation stages are incast- and self-traffic-free,
        payloads fit their slots, blocks are shape-consistent, and (for
        capacity-aware plans) every stage is slot-vs-rail feasible on the
        plan's own fabric.  The static plan verifier (analysis/planlint.py)
        audits serialized plans and live cache contents through this entry
        point, where no workload is available.
        """
        for p in self.phases:
            if isinstance(p, PermutationStage):
                live = [j for j in p.perm if j >= 0]
                if len(live) != len(set(live)):
                    raise PlanValidationError(
                        f"permutation stage has incast: {p.perm}")
                if any(i == j for i, j in enumerate(p.perm)):
                    raise PlanValidationError(
                        f"permutation stage has self-traffic: {p.perm}")
                if p.size < 0 or any(s < 0 or s > p.size * (1 + rtol)
                                     for s in p.sent):
                    raise PlanValidationError(
                        "permutation stage payload exceeds slot size")
                if p.slots is not None:
                    if len(p.slots) != len(p.perm):
                        raise PlanValidationError(
                            f"permutation stage has {len(p.perm)} senders "
                            f"but {len(p.slots)} slot sizes")
                    if any(sl < 0 or sl > p.size * (1 + rtol)
                           for sl in p.slots):
                        raise PlanValidationError(
                            "per-sender slot exceeds the stage size")
                    if any(s > sl * (1 + rtol)
                           for s, sl in zip(p.sent, p.slots)):
                        raise PlanValidationError(
                            "permutation stage payload exceeds its "
                            "per-sender slot")
            elif isinstance(p, PermutationBlock):
                self._validate_block(p, rtol)
        if self.capacity_aware:
            self._check_slot_rail_feasibility(rtol)

    def _validate_block(self, p: "PermutationBlock", rtol: float) -> None:
        """PermutationStage structural checks, vectorized over a block."""
        perms = np.asarray(p.perms, dtype=np.int64)
        sent = np.asarray(p.sent, dtype=np.float64)
        sizes = np.asarray(p.sizes, dtype=np.float64)
        s_count, n = perms.shape
        if sent.shape != (s_count, n) or sizes.shape != (s_count,):
            raise PlanValidationError(
                f"permutation block arrays disagree: perms {perms.shape}, "
                f"sent {sent.shape}, sizes {sizes.shape}")
        live = perms >= 0
        if s_count:
            dst = np.where(live, perms, 0)
            if int(perms.max(initial=-1)) >= n or \
                    int(perms.min(initial=0)) < -1:
                raise PlanValidationError(
                    "permutation block destination out of range")
            recv = np.zeros((s_count, n))
            np.add.at(recv, (np.arange(s_count)[:, None], dst),
                      live.astype(np.float64))
            if recv.max(initial=0.0) > 1:
                k = int(np.argwhere(recv > 1)[0][0])
                raise PlanValidationError(
                    f"permutation stage has incast: "
                    f"{tuple(perms[k].tolist())}")
            if bool((live & (perms == np.arange(n)[None, :])).any()):
                raise PlanValidationError(
                    "permutation block stage has self-traffic")
        if (sizes < 0).any() or (sent < 0).any() or \
                (sent > sizes[:, None] * (1 + rtol)).any():
            raise PlanValidationError(
                "permutation stage payload exceeds slot size")
        if p.slots is not None:
            slots = np.asarray(p.slots, dtype=np.float64)
            if slots.shape != (s_count, n):
                raise PlanValidationError(
                    f"permutation block has {s_count}x{n} senders but "
                    f"{slots.shape} slot sizes")
            if (slots < 0).any() or \
                    (slots > sizes[:, None] * (1 + rtol)).any():
                raise PlanValidationError(
                    "per-sender slot exceeds the stage size")
            if (sent > slots * (1 + rtol)).any():
                raise PlanValidationError(
                    "permutation stage payload exceeds its per-sender slot")

    def _check_slot_rail_feasibility(self, rtol: float) -> None:
        """Capacity-aware invariant: within each permutation stage, no rail
        of any live pair needs longer than the stage's window (the slowest
        pair's slot over its pair capacity) to drain its share of the slot.
        Capacity-proportional slots + shares satisfy this with equality;
        uniform shares grafted onto heterogeneous slots (or slots from a
        different fabric than ``topology``) fail it loudly.

        Pairs with zero pair capacity are excluded from both the window and
        the rail check: a fully-failed pair makes the stage take forever
        regardless of shares (the executor reports infinity), and letting
        its infinite window vouch for the *healthy* pairs would make the
        check vacuous exactly when the fabric is most degraded.
        """
        from .topology import bw_div

        topo = self.topo
        caps = topo.pair_capacity()
        m = topo.m_gpus
        shares = (self.nic_shares if self.nic_shares is not None
                  else uniform_nic_shares(topo.n_servers, m))
        for k, p in enumerate(self.phases):
            if isinstance(p, PermutationBlock):
                self._check_block_rails(p, k, caps, shares, topo, rtol)
                continue
            if not isinstance(p, PermutationStage):
                continue
            src, dst, slot = p.live()
            finite = caps[src, dst] > 0
            src, dst, slot = src[finite], dst[finite], slot[finite]
            if src.size == 0:
                continue
            window = float(bw_div(slot, caps[src, dst]).max(initial=0.0))
            rail_caps = np.minimum(topo.nic_tx[src], topo.nic_rx[dst])
            rail_t = bw_div(slot[:, None] * shares[src, dst], rail_caps)
            worst = float(rail_t.max(initial=0.0))
            if worst > window * (1 + rtol):
                raise PlanValidationError(
                    f"stage {k} is slot-vs-rail infeasible: a rail needs "
                    f"{worst:.6g}s to drain its share but the stage window "
                    f"is {window:.6g}s (shares inconsistent with the "
                    "fabric's pair capacities?)")

    def _check_block_rails(self, p: "PermutationBlock", k: int,
                           caps: np.ndarray, shares: np.ndarray,
                           topo: Topology, rtol: float) -> None:
        """Slot-vs-rail feasibility over a whole block in one pass: the
        same per-stage invariant as the PermutationStage branch, with the
        per-stage window and worst-rail reductions batched over S stages."""
        from .topology import bw_div

        s_count, n = p.perms.shape
        if s_count == 0:
            return
        mask, dst, slot = p.live_batch()
        stage_i, src = np.nonzero(mask)
        d = dst[stage_i, src]
        sl = slot[stage_i, src]
        finite = caps[src, d] > 0
        stage_i, src, d, sl = (stage_i[finite], src[finite], d[finite],
                               sl[finite])
        if src.size == 0:
            return
        windows = np.zeros(s_count)
        np.maximum.at(windows, stage_i, bw_div(sl, caps[src, d]))
        rail_caps = np.minimum(topo.nic_tx[src], topo.nic_rx[d])
        rail_t = bw_div(sl[:, None] * shares[src, d], rail_caps).max(axis=1)
        worst = np.zeros(s_count)
        np.maximum.at(worst, stage_i, rail_t)
        bad = worst > windows * (1 + rtol)
        if bad.any():
            b = int(np.flatnonzero(bad)[0])
            raise PlanValidationError(
                f"stage {k}[{b}] is slot-vs-rail infeasible: a rail needs "
                f"{worst[b]:.6g}s to drain its share but the stage window "
                f"is {windows[b]:.6g}s (shares inconsistent with the "
                "fabric's pair capacities?)")


# -- synthesis caching ----------------------------------------------------

def _family_key(cluster: ClusterSpec, topo_fingerprint: str,
                algorithm: str) -> str:
    h = hashlib.blake2b(digest_size=16)
    h.update(repr(dataclasses.astuple(cluster)).encode())
    h.update(topo_fingerprint.encode())
    h.update(algorithm.encode())
    return h.hexdigest()


def cluster_family_key(w: Workload, algorithm: str = "") -> str:
    """Fingerprint of (cluster, topology, algorithm) *without* the traffic
    matrix: every workload of a job on a fixed fabric shares it.

    PlanCache's warm-start path uses it to find "the most recent plan for
    this cluster and algorithm" when the exact traffic fingerprint misses --
    dynamic MoE traffic rarely repeats exactly, but consecutive iterations
    are near-misses that can seed a repair instead of a cold synthesis.
    The ClusterSpec scalars are hashed alongside the topology fingerprint
    because repair requires the previous plan's cluster to match exactly
    (e.g. two specs can share a fabric but differ in alpha).
    """
    return _family_key(w.cluster, w.topo.fingerprint(), algorithm)


def plan_family_key(plan: Plan) -> str:
    """The family key a synthesized Plan belongs to.

    Agrees with ``cluster_family_key(w, plan.algorithm)`` for the workload
    the plan was synthesized from, which lets ``PlanCache.insert`` maintain
    the family index from the plan alone (and prune it on eviction).
    """
    return _family_key(plan.cluster, plan.topo.fingerprint(), plan.algorithm)


def traffic_fingerprint(w: Workload, algorithm: str = "") -> str:
    """Stable fingerprint of (traffic matrix, topology, algorithm).

    Dynamic MoE traffic changes every iteration but frequently repeats
    signatures (hot expert sets recur across steps); an exact content hash
    is what lets PlanCache skip re-synthesis on repeats while never serving
    a stale plan for different traffic.  The topology fingerprint (which
    covers the cluster shape, every per-server fabric, every NIC capacity
    and the oversubscription factor) is part of the key, so the same matrix
    replayed on a different fabric always misses.

    Memoized per (Workload instance, algorithm): Workload is frozen and
    its matrix is treated as immutable after construction (same contract
    as the memoized ``Workload.topo``), and the content hash is the
    dominant cost of a cache hit on the serving fast path -- replaying a
    trajectory of Workload objects must not re-hash every matrix on every
    visit.
    """
    memo = w.__dict__.get("_traffic_fp")
    if memo is not None:
        fp = memo.get(algorithm)
        if fp is not None:
            return fp
    h = hashlib.blake2b(digest_size=16)
    mat = np.ascontiguousarray(w.matrix, dtype=np.float64)
    h.update(str(mat.shape).encode())
    h.update(mat.tobytes())
    h.update(w.topo.fingerprint().encode())
    h.update(algorithm.encode())
    fp = h.hexdigest()
    if memo is None:
        memo = {}
        object.__setattr__(w, "_traffic_fp", memo)
    memo[algorithm] = fp
    return fp


class PlanCache:
    """LRU cache of synthesized Plans keyed by traffic fingerprint.

    The paper's synthesis is already microseconds-cheap, but at MoE serving
    rates (thousands of iterations/second across layers) even that adds up
    -- and expert-routing signatures repeat across iterations.  ``lookup``
    /``get_or_synthesize`` skip re-synthesis on a repeated fingerprint and
    expose hit/miss counters for the reuse-rate telemetry.

    With ``warm_start=True``, an exact-fingerprint miss falls back to the
    most recent cached plan for the same (cluster, topology, algorithm)
    family: schedulers exposing ``repair_plan`` (FLASH) then seed the new
    plan with the cached plan's permutations and synthesize only the
    traffic delta, so a small MoE routing shift costs a repair instead of a
    cold synthesis.  Warm repairs still count as misses (a fresh plan is
    produced) and are tallied separately in ``warm_hits``.  Off by default:
    a repaired plan is byte-conserving and incast-free but generally a
    slightly longer stage list than cold synthesis, so reuse-vs-quality is
    an explicit opt-in.

    Compiled execution rides along for free: ``Plan.compile`` memoizes its
    ``ExecutableSchedule`` *on the plan object*, keyed by the execution
    topology's fingerprint, so a cache hit hands back a plan whose
    compiled schedule is already attached -- the serving loop skips
    synthesis and compilation and pays only the O(1) compiled execute.

    The cache is safe under concurrent access (the plan-serving daemon in
    ``repro.serving`` shares one instance across worker and client
    threads): one lock guards the LRU store, the family index and the
    counters, ``stats()`` returns an atomic snapshot of the counters (the
    bare attributes remain readable for back-compat but can tear across a
    multi-field read), and ``get_or_synthesize`` never holds the lock
    during synthesis -- two threads racing the same fingerprint may both
    synthesize, but the insert re-check keeps one canonical Plan per key
    so every caller gets the same object.
    """

    def __init__(self, capacity: int = 256, warm_start: bool = False):
        if capacity < 1:
            raise ValueError("capacity must be >= 1")
        self.capacity = capacity
        self.warm_start = warm_start
        self._lock = make_rlock("PlanCache._lock")
        self._store: "OrderedDict[str, Plan]" = OrderedDict()
        self._family: Dict[str, str] = {}  # family key -> latest exact key
        self._key_family: Dict[str, str] = {}  # exact key -> its family
        self._family_count: Dict[str, int] = {}  # family -> live cached keys
        self.hits = 0
        self.misses = 0
        self.warm_hits = 0

    def __len__(self) -> int:
        with self._lock:
            return len(self._store)

    @property
    def hit_rate(self) -> float:
        with self._lock:
            total = self.hits + self.misses
            return self.hits / total if total else 0.0

    def stats(self) -> Dict[str, float]:
        """Atomic snapshot of the counters.

        Reading ``hits`` / ``misses`` / ``hit_rate`` as separate attribute
        accesses can tear mid-update under concurrent serving (a lookup
        between the two reads skews the ratio); this returns all of them
        from one critical section."""
        with self._lock:
            total = self.hits + self.misses
            return {
                "hits": self.hits,
                "misses": self.misses,
                "warm_hits": self.warm_hits,
                "size": len(self._store),
                "capacity": self.capacity,
                "hit_rate": self.hits / total if total else 0.0,
            }

    def clear(self) -> None:
        with self._lock:
            self._store.clear()
            self._family.clear()
            self._key_family.clear()
            self._family_count.clear()
            self.hits = 0
            self.misses = 0
            self.warm_hits = 0

    def lookup(self, key: str) -> Optional[Plan]:
        with self._lock:
            plan = self._store.get(key)
            if plan is not None:
                self._store.move_to_end(key)
                self.hits += 1
            else:
                self.misses += 1
            return plan

    def peek(self, key: str) -> Optional[Plan]:
        """Counter-free, order-preserving lookup.

        The serving daemon's workers re-check the store after a client's
        fast-path miss already counted; a second ``lookup`` would double
        count and perturb the LRU order for what is one logical request.
        """
        with self._lock:
            return self._store.get(key)

    def peek_family(self, family: str) -> Optional[Plan]:
        """The most recent cached plan of a (cluster, topology, algorithm)
        family (see ``cluster_family_key``), without touching counters --
        the warm-repair seed for the serving daemon's near-miss path."""
        with self._lock:
            key = self._family.get(family)
            return self._store.get(key) if key is not None else None

    def family_heads(self) -> List[Tuple[str, Plan]]:
        """Snapshot of every family's canonical (MRU) plan: ``(family
        key, plan)`` pairs.  The fabric-event pipeline walks this to find
        the plan families a topology change affects (those whose plan
        carries the pre-event fabric fingerprint) and re-repair each one
        against the new capacities instead of letting it go cold."""
        with self._lock:
            return [(family, self._store[key])
                    for family, key in self._family.items()
                    if key in self._store]

    def evict(self, key: str) -> bool:
        """Drop one entry (and its family-index membership) by exact key.

        Returns whether the key was present.  TTL/staleness policies
        layered on top of the LRU (serving/policy.py) use this to expire
        entries the LRU order alone would keep alive."""
        with self._lock:
            plan = self._store.pop(key, None)
            if plan is None:
                return False
            self._drop_family_member_locked(key, self._key_family.pop(key))
            return True

    def insert(self, key: str, plan: Plan) -> None:
        with self._lock:
            self._insert_locked(key, plan)

    def _insert_locked(self, key: str, plan: Plan) -> None:
        family = plan_family_key(plan)
        old_family = self._key_family.get(key)
        if old_family is not None and old_family != family:
            # Overwrite with a different-family plan (hand-inserted key).
            del self._key_family[key]
            self._drop_family_member_locked(key, old_family)
        self._store[key] = plan
        self._store.move_to_end(key)
        if key not in self._key_family:
            self._key_family[key] = family
            self._family_count[family] = \
                self._family_count.get(family, 0) + 1
        self._family[family] = key
        while len(self._store) > self.capacity:
            evicted, _ = self._store.popitem(last=False)
            self._drop_family_member_locked(evicted, self._key_family.pop(evicted))

    def _drop_family_member_locked(self, key: str, family: str) -> None:
        """Keep the family index in lockstep with the LRU store: without
        this, long-running serving grows ``_family`` without bound and a
        stale family -> evicted-key pointer silently turns every warm start
        cold.  The membership count makes the common case -- one cached
        plan per fabric, family dies with its key -- O(1); only a family
        with surviving members pays a scan to repoint at the most recently
        used survivor."""
        remaining = self._family_count[family] - 1
        if remaining:
            self._family_count[family] = remaining
        else:
            del self._family_count[family]
        if self._family.get(family) != key:
            return
        if not remaining:
            del self._family[family]
            return
        for other in reversed(self._store):
            if self._key_family.get(other) == family:
                self._family[family] = other
                return
        del self._family[family]  # unreachable while counts are coherent

    def get_or_synthesize(self, scheduler, w: Workload) -> Plan:
        """Return the cached Plan for (w, scheduler) or synthesize + cache.

        On an exact miss with ``warm_start`` enabled, a same-family cached
        plan seeds ``scheduler.repair_plan`` instead of a cold synthesis.

        Thread-safe, and synthesis runs *outside* the lock: concurrent
        misses on the same fingerprint may each synthesize, but the insert
        re-check below keeps the first inserted Plan canonical -- later
        racers return it instead of overwriting, so repeated lookups of
        one fingerprint always yield one object (and its memoized
        compiled schedule).
        """
        key = traffic_fingerprint(w, scheduler.name)
        with self._lock:
            plan = self._store.get(key)
            if plan is not None:
                self._store.move_to_end(key)
                self.hits += 1
                return plan
            self.misses += 1
            prev = None
            if self.warm_start and hasattr(scheduler, "try_repair_plan"):
                prev = self._store.get(
                    self._family.get(cluster_family_key(w, scheduler.name),
                                     ""))
                # The family key pins (cluster, topology, algorithm), but a
                # stale or hand-inserted entry must degrade to cold, never
                # propagate a repair error out of a cache lookup.
                if prev is not None and (prev.cluster != w.cluster or
                                         prev.topo.fingerprint()
                                         != w.topo.fingerprint()):
                    prev = None
        plan = None
        if prev is not None:
            plan = scheduler.try_repair_plan(prev, w, fingerprint=key)
        warm = plan is not None
        if plan is None:
            plan = scheduler.synthesize(w, fingerprint=key)
        with self._lock:
            existing = self._store.get(key)
            if existing is not None:  # lost the race: keep the canonical plan
                self._store.move_to_end(key)
                return existing
            if warm:
                self.warm_hits += 1
            self._insert_locked(key, plan)  # repoints _family[family] to key
        return plan
