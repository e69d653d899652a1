"""Link-level plan executor (paper 6.3), compiled for dynamic MoE serving.

One executor times *every* scheduler.  It understands a scheduler-agnostic
``Plan`` (core/plan.py) against the *named resources* of a ``Topology``
(core/topology.py) -- per-NIC send/recv occupancy, per-server intra
fabrics, and the scale-out spine:

  * every flow is pinned to the NICs and fabrics it actually crosses: an
    inter-server flow is limited by ``min`` of its endpoint NIC capacities,
    an intra-server flow by its server's fabric;
  * a server's inter-server slot bytes are split across its NICs by the
    plan's ``nic_shares`` (FLASH's capacity-proportional rebalance target;
    uniform 1/m when the plan is topology-blind) -- on a degraded or
    mixed-speed fabric the blind uniform split strands bytes on the slow
    NIC while the aware split keeps every NIC draining simultaneously;
  * every inter phase is additionally bounded by the spine:
    ``stage_inter_bytes / (sum(nic_bw) / oversubscription)`` -- inert at
    full bisection, binding when the scale-out tier is oversubscribed.

There are two execution paths over one timing model:

  * **Compiled (default)** -- ``compile_plan(plan, topology)`` (or
    ``Plan.compile()``) flattens all phases into padded array form once --
    stacked (S, n) permutation/slot matrices, gathered rail shares,
    receiver-fabric vectors, spine divisors -- and times every permutation
    stage, hidden redistribute and barrier stage in one vectorized pass.
    The resulting ``ExecutableSchedule`` carries the finished breakdown
    (the timing model depends only on (plan, topology), never on which
    traffic matrix is being accounted), so ``execute(w)`` costs one
    matrix reduction and ``execute_batch`` amortizes even that over a
    (B, N, N) stack.  ``Plan.compile`` memoizes the schedule on the plan
    per execution-topology fingerprint, so a ``PlanCache`` hit skips
    synthesis *and* compilation -- the serving-loop regime where traffic
    shifts every few hundred milliseconds and the executor used to re-walk
    O(stages) Python per iteration.
  * **Interpreted (oracle)** -- ``execute_plan(..., reference=True)``
    keeps the original per-phase walk, like
    ``birkhoff_decompose(reference=True)``: the compiled path is
    parity-tested against it to <= 1e-12 for every registered scheduler
    (tests/test_compiled_executor.py).

On a homogeneous topology all of this reduces algebraically to the scalar
alpha-beta model (each transfer costs ``alpha + bytes / bandwidth``;
concurrent transfers on a shared resource divide its bandwidth), and the
executor reproduces the scalar executor's completion times to <= 1e-9
relative error (golden-tested in tests/test_plan_ir.py).

Incast and straggler effects remain properties of stage *types*, not
algorithm names:

  * PermutationStage -- incast-free/straggler-free; ascending consecutive
    stages pipeline (stage k's redistribute hides under stage k+1's
    transfer; the un-hidden residual is charged explicitly, so the Theorem 2
    bound holds even when the intra fabric is slow -- ring topology,
    Fig 16a).
  * BarrierStage -- waits for its slowest flow (the straggler effect,
    Fig 3b).
  * FanOutBurst -- models incast collapse: once simultaneous inbound flow
    bytes at a NIC exceed what switch buffers absorb, goodput degrades by
    1 / (1 + gamma * (k - 1)) (retransmissions + queueing), matching the
    ~91x degradation the paper measured for RCCL at 32 GPUs on large
    balanced transfers (Fig 12a).  Size-weighted effective concurrency:
    short flows drain early, so skew *reduces* collision frequency.
  * RailStage -- the max-loaded rail is the straggler; one wakeup per
    rotation round.
  * BoundStage -- the Theorem 1 analytic bound, per-server line sums
    against per-server aggregate NIC capacity.

The figure of merit is *algorithmic bandwidth*:

    AlgoBW = total_bytes / completion_time / n_gpus      [bytes/s/GPU]

``simulate(w, name)`` is the one-call pipeline: registry lookup ->
synthesis (optionally via a PlanCache) -> compiled execution.
``simulate_many(workloads, name, cache=...)`` is its batched front door
for traffic trajectories.  Passing ``topology=`` executes a plan on a
*different* fabric than it was synthesized for -- the topology-blindness
experiment of benchmarks/fig_hetero.py.
"""

from __future__ import annotations

import dataclasses
from types import MappingProxyType
from typing import Dict, Iterator, List, Mapping, Optional, Sequence, Union

import numpy as np

from .plan import (
    BarrierStage,
    BoundStage,
    FanOutBurst,
    IntraOverlapPhase,
    LoadBalancePhase,
    PermutationBlock,
    PermutationStage,
    Plan,
    PlanCache,
    RailStage,
    RedistributePhase,
)
from .birkhoff import live_slots_batch
from .schedulers import SCHEDULERS, get_scheduler
from .topology import (
    Topology,
    bw_div as _div,
    bw_sdiv as _sdiv,
    uniform_nic_shares,
)
from .traffic import Workload

__all__ = [
    "SimResult",
    "ExecutableSchedule",
    "compile_plan",
    "simulate",
    "simulate_many",
    "execute_plan",
    "ALGORITHMS",
]

# Incast model constants (FanOutBurst stages only).
_INCAST_GAMMA = 4.0
_INCAST_BUFFER_BYTES = 32e6  # per-receiver absorption before collapse

# The compiler's vectorized stage pass works on (block, n, m) scratch
# arrays; blocking bounds peak scratch memory at large stage counts
# (n=256 has ~65k stages) without ever falling back to per-stage Python.
_COMPILE_BLOCK_ELEMS = 4_000_000


@dataclasses.dataclass(frozen=True)
class SimResult:
    algorithm: str
    completion_time: float
    algbw: float  # bytes / s / GPU
    breakdown: Dict[str, float]
    n_stages: int
    synth_seconds: float
    memory_bytes: float  # peak buffer footprint across the job

    def algbw_gbps(self) -> float:
        return self.algbw / 1e9


# -- interpreted oracle ----------------------------------------------------
#
# The original per-phase walk.  Kept verbatim as the parity oracle for the
# compiled path (``execute_plan(..., reference=True)``), exactly like the
# reference Birkhoff decomposer backs the incremental engines.

def _perm_stage_time(topo: Topology, ph: PermutationStage,
                     shares: np.ndarray) -> float:
    """One permutation stage, link-level (no alpha): each live sender i
    ships its slot to perm[i] -- the uniform ``size`` bytes, or its
    per-sender ``slots[i]`` when the stage is capacity-aware -- split
    across its NICs by ``shares``; rail g of the pair is capped by the
    slower endpoint NIC; the stage also crosses the spine once."""
    src, dst, slot = ph.live()
    if src.size == 0:
        return 0.0
    rail_caps = np.minimum(topo.nic_tx[src], topo.nic_rx[dst])  # (k, m)
    flows = slot[:, None] * shares[src, dst]                    # (k, m)
    spine_bytes = (ph.size * len(src) if ph.slots is None  # exact blind form
                   else float(slot.sum()))
    t = float(_div(flows, rail_caps).max(initial=0.0))
    spine = _sdiv(spine_bytes, topo.spine_bandwidth)
    return max(t, spine)


def _stage_redistribute_time(topo: Topology, ph: PermutationStage,
                             worst_a2a: float) -> float:
    """Hidden redistribute of one stage: each *receiver* spreads its slot
    over its own server fabric, so the stage is charged at the worst fabric
    it actually touches -- not the cluster-wide slowest (that model
    overcharges every fast server on mixed fabrics).  Padding-only stages
    keep the legacy cluster-min charge (they touch no server)."""
    m = topo.m_gpus
    src, dst, slot = ph.live()
    if src.size == 0:
        return _sdiv(ph.size / m, worst_a2a)
    return float(_div(slot / m, topo.intra_a2a_bw[dst]).max(initial=0.0))


def _tail_redistribute_time(topo: Topology, bytes_per_gpu: float,
                            last_stage: Optional[PermutationStage]) -> float:
    """Tail RedistributePhase: the *last* permutation stage's redistribute.
    Receiver j spreads its share of the tail bytes -- scaled by its slot's
    fraction of the stage (slot_j / size; 1 for uniform slots) -- over its
    own fabric, like the hidden redistributes.  Plans without permutation
    stages (hierarchical scatter) keep the conservative cluster-min charge.
    """
    if last_stage is not None and last_stage.size > 0:
        src, dst, slot = last_stage.live()
        if src.size:
            per_recv = bytes_per_gpu * (slot / float(last_stage.size))
            return float(_div(per_recv,
                              topo.intra_a2a_bw[dst]).max(initial=0.0))
    return _sdiv(bytes_per_gpu, float(topo.intra_a2a_bw.min()))


def _permutation_times(topo: Topology, stages: List[PermutationStage],
                       shares: np.ndarray) -> Dict[str, float]:
    """Ascending Birkhoff stage pipeline (paper 4.3 / Theorem 2).

    inter: sum over stages of alpha + link-level stage time.
    hidden_residual: stage k's redistribute must fit under stage k+1's
      transfer because l_k <= l_{k+1} and B1 > B2 (Theorem 2 pipelining
      argument); any excess is charged.  The redistribute rides the worst
      fabric among the stage's receivers.
    """
    worst_a2a = float(topo.intra_a2a_bw.min())
    times = [_perm_stage_time(topo, ph, shares) for ph in stages]
    inter = 0.0
    hidden_residual = 0.0
    for k, ph in enumerate(stages):
        inter += topo.alpha + times[k]
        if k + 1 < len(stages):
            redis = _stage_redistribute_time(topo, ph, worst_a2a)
            hidden_residual += max(0.0, redis - times[k + 1])
    return {"inter": inter, "hidden_residual": hidden_residual}


def _fanout_time(topo: Topology, ph: FanOutBurst) -> float:
    """One burst: receiver NICs fair-share + incast; sender uplinks bound;
    intra traffic rides each server's fabric concurrently; one wakeup."""
    n, m = topo.n_servers, topo.m_gpus
    nic = topo.nic_rx  # inbound fair-share + incast ride the receive plane
    blk = ph.matrix.reshape(n, m, n, m)
    # Zero the same-server sender rows per receiver: intra rides the fast
    # fabric, not the NIC.
    inter_flows = blk * (1.0 - np.eye(n))[:, None, :, None]
    inbound = inter_flows.sum(axis=(0, 1))          # (n, m) per receiver NIC
    fmax = inter_flows.max(axis=(0, 1), initial=0.0)
    senders = np.divide(inbound, fmax, out=np.zeros_like(inbound),
                        where=fmax > 0)
    base = _div(inbound, nic)
    collapse = (inbound > _INCAST_BUFFER_BYTES) & (senders > 1)
    if collapse.any():
        over = inbound - _INCAST_BUFFER_BYTES
        eta = 1.0 / (1.0 + _INCAST_GAMMA * (senders - 1))
        collapsed = (_div(np.full_like(inbound, _INCAST_BUFFER_BYTES), nic)
                     + _div(np.maximum(over, 0.0), nic * eta))
        base = np.where(collapse, collapsed, base)
    t = float(base.max(initial=0.0))
    # Sender uplinks (no incast on the send side).
    outbound = inter_flows.sum(axis=(2, 3))          # (n, m) per sender NIC
    t = max(t, float(_div(outbound, topo.nic_tx).max(initial=0.0)))
    # Intra traffic rides each server's fabric concurrently.
    intra_per_gpu = np.einsum("agah->ag", blk)       # (n, m)
    t = max(t, float(_div(intra_per_gpu,
                          topo.intra_a2a_bw[:, None]).max(initial=0.0)))
    # Everything crosses the spine at once.
    t = max(t, _sdiv(float(inter_flows.sum()), topo.spine_bandwidth))
    return t + topo.alpha


def _barrier_time(topo: Topology, ph: BarrierStage) -> float:
    """Slowest flow of a barrier-synchronized flow set, each flow pinned to
    the resources it crosses (endpoint NICs, or the source server fabric)."""
    m = topo.m_gpus
    src = np.arange(len(ph.sizes))
    dst = ph.dsts.astype(np.int64)
    src_s, src_g = src // m, src % m
    dst_s, dst_g = dst // m, dst % m
    same = src_s == dst_s
    inter_caps = np.minimum(topo.nic_tx[src_s, src_g],
                            topo.nic_rx[dst_s, dst_g])
    bw = np.where(same, topo.intra_path_bw[src_s], inter_caps)
    stage = float(_div(ph.sizes, bw).max(initial=0.0))
    spine = _sdiv(float(ph.sizes[~same].sum()), topo.spine_bandwidth)
    return max(stage, spine)


# The remaining phase types are timed by shared helpers used verbatim by
# the interpreted walk and the compiler so the two paths cannot drift.

def _overlap_residual_time(topo: Topology, ph: IntraOverlapPhase,
                           inter_total: float) -> float:
    """Local traffic S_i spreads over the m GPUs' intra fabric and overlaps
    the inter phase; only the residual beyond it is charged."""
    v = float(_div(ph.per_server,
                   topo.m_gpus * topo.intra_a2a_bw).max(initial=0.0))
    intra_t = (v + topo.alpha) if float(
        ph.per_server.max(initial=0.0)) > 0 else 0.0
    return max(0.0, intra_t - inter_total)


def _simple_phase_time(topo: Topology, ph, last_stage, add) -> int:
    """Time one of the one-per-plan phase types, shared verbatim by the
    interpreted walk and the compiler; returns the stage-count increment.
    ``last_stage`` is the plan's final permutation stage (the pipeline
    tail's shape), or None.  Permutation, barrier and overlap phases are
    each path's own business (batched vs per-phase); anything else unknown
    is an error."""
    if isinstance(ph, LoadBalancePhase):
        head = float(_div(ph.moved_per_gpu,
                          topo.intra_a2a_bw[:, None]).max(initial=0.0))
        if ph.charge_alpha and float(
                ph.moved_per_gpu.max(initial=0.0)) > 0:
            head += topo.alpha
        add("head", head)
        return 0
    if isinstance(ph, FanOutBurst):
        add("inter", _fanout_time(topo, ph))
        return 1
    if isinstance(ph, RailStage):
        rail = max(float(_div(ph.send, topo.nic_tx).max(initial=0.0)),
                   float(_div(ph.recv, topo.nic_rx).max(initial=0.0)))
        spine = _sdiv(float(ph.send.sum()), topo.spine_bandwidth)
        add("inter", max(rail, spine))
        add("sync", topo.alpha * max(ph.n_rounds, 1))
        return ph.n_rounds
    if isinstance(ph, BoundStage):
        if ph.line_sums is not None:
            t = topo.theorem1_time(ph.line_sums, ph.inter_total)
        else:  # legacy scalar form (pre-topology serialized plans)
            t = max(_sdiv(ph.bound_bytes, float(topo.send_caps.max())),
                    _sdiv(ph.inter_total, topo.spine_bandwidth))
        add("inter", t)
        return 1
    if isinstance(ph, RedistributePhase):
        tail = _tail_redistribute_time(topo, ph.bytes_per_gpu, last_stage)
        if ph.charge_alpha:
            tail += topo.alpha
        add("tail", tail)
        return 0
    raise TypeError(f"executor cannot time phase {ph!r}")


def _check_execution_shape(plan: Plan, topo: Topology) -> None:
    if (topo.n_servers, topo.m_gpus) != (plan.cluster.n_servers,
                                         plan.cluster.m_gpus):
        raise ValueError(
            f"execution topology shape ({topo.n_servers}, {topo.m_gpus}) "
            f"!= plan shape ({plan.cluster.n_servers}, "
            f"{plan.cluster.m_gpus})")


def _plan_shares(plan: Plan, topo: Topology) -> np.ndarray:
    """The plan's rail shares, or the memoized uniform fallback (the old
    executor allocated a fresh (n, n, m) array per call for every
    non-FLASH plan)."""
    if plan.nic_shares is not None:
        return plan.nic_shares
    return uniform_nic_shares(topo.n_servers, topo.m_gpus)


def _execute_plan_interpreted(plan: Plan, w: Workload,
                              topology: Optional[Topology] = None
                              ) -> SimResult:
    """The original per-phase walk (see ``execute_plan``)."""
    topo = topology if topology is not None else plan.topo
    _check_execution_shape(plan, topo)
    breakdown: Dict[str, float] = {}
    n_stages = 0
    overlap_phases = []

    def add(key: str, dt: float) -> None:
        breakdown[key] = breakdown.get(key, 0.0) + dt

    perm_stages: List[PermutationStage] = []
    for p in plan.phases:
        if isinstance(p, PermutationStage):
            perm_stages.append(p)
        elif isinstance(p, PermutationBlock):
            perm_stages.extend(p.iter_stages())  # per-stage oracle walk
    if perm_stages:
        shares = _plan_shares(plan, topo)
        for key, dt in _permutation_times(topo, perm_stages,
                                          shares).items():
            add(key, dt)
        n_stages += len(perm_stages)
    last_stage = perm_stages[-1] if perm_stages else None

    for ph in plan.phases:
        if isinstance(ph, (PermutationStage, PermutationBlock)):
            continue  # timed collectively above (pipelined group)
        if isinstance(ph, BarrierStage):
            stage = _barrier_time(topo, ph)
            if stage > 0:
                add("inter", topo.alpha + stage)
            n_stages += 1
        elif isinstance(ph, IntraOverlapPhase):
            overlap_phases.append(ph)
        else:
            n_stages += _simple_phase_time(topo, ph, last_stage, add)

    # Overlap phases resolve against the finished inter total.
    for ph in overlap_phases:
        add("intra_residual",
            _overlap_residual_time(topo, ph, breakdown.get("inter", 0.0)))

    t = max(sum(breakdown.values()), 1e-30)
    total = w.total_bytes
    # Memory: send + recv buffers (2x) plus algorithm-specific staging.
    mem = 2.0 * total + plan.extra_memory_bytes
    return SimResult(
        algorithm=plan.algorithm,
        completion_time=t,
        algbw=total / t / topo.n_gpus,
        breakdown=breakdown,
        n_stages=n_stages,
        synth_seconds=plan.synth_seconds,
        memory_bytes=mem,
    )


# -- compiled execution ----------------------------------------------------

TrafficBatch = Union[np.ndarray, Sequence[Union[Workload, np.ndarray]]]


@dataclasses.dataclass(frozen=True, eq=False)
class ExecutableSchedule:
    """A Plan compiled against one execution Topology.

    The link-level timing model is a function of (plan, topology) only --
    the traffic matrix enters execution solely through its byte total
    (AlgoBW / memory accounting) -- so compilation finishes the entire
    breakdown once and ``execute`` is O(1) beyond that reduction.  Built
    by ``compile_plan`` / ``Plan.compile`` (which memoizes per topology
    fingerprint); parity with the interpreted executor is <= 1e-12
    (tests/test_compiled_executor.py).
    """

    plan: Plan
    topology: Topology
    completion_time: float
    # Read-only: the schedule is shared by every execute() of a memoized
    # compile, and completion_time is precomputed from these values.
    breakdown: Mapping[str, float]
    n_stages: int

    def _result(self, total_bytes: float) -> SimResult:
        t = self.completion_time
        plan = self.plan
        return SimResult(
            algorithm=plan.algorithm,
            completion_time=t,
            algbw=total_bytes / t / self.topology.n_gpus,
            breakdown=dict(self.breakdown),
            n_stages=self.n_stages,
            synth_seconds=plan.synth_seconds,
            memory_bytes=2.0 * total_bytes + plan.extra_memory_bytes,
        )

    def lower_device(self, n_pods: Optional[int] = None):
        """The device lowering of this schedule's plan (a DeviceSchedule).

        Bridges to ``comm.plan_exec.lower_plan`` -- lazily, so the
        host-only core keeps importing without jax.  Memoized on the plan
        per pod count, like ``Plan.compile`` per topology fingerprint.
        """
        from ..comm.plan_exec import lower_plan

        return lower_plan(self.plan, n_pods=n_pods)

    def _check_workload(self, w: Workload) -> None:
        if (w.cluster.n_servers, w.cluster.m_gpus) != (
                self.plan.cluster.n_servers, self.plan.cluster.m_gpus):
            raise ValueError(
                f"workload shape ({w.cluster.n_servers}, "
                f"{w.cluster.m_gpus}) != compiled plan shape "
                f"({self.plan.cluster.n_servers}, "
                f"{self.plan.cluster.m_gpus})")

    def execute(self, w: Workload) -> SimResult:
        """Account one workload against the compiled timing."""
        self._check_workload(w)
        return self._result(w.total_bytes)

    def execute_batch(self, traffic: TrafficBatch) -> List[SimResult]:
        """Time a whole trajectory of traffic against this schedule.

        ``traffic`` is a (B, N, N) stack of GPU-level matrices (one NumPy
        reduction for the batch), or a sequence of Workloads / matrices.
        Element b of the result equals ``execute_plan(plan, w_b)`` exactly
        -- the batched form of the dynamic-MoE drift experiment, where one
        synthesized schedule is held while traffic shifts under it.
        """
        n_gpus = self.plan.cluster.n_gpus
        if isinstance(traffic, np.ndarray):
            if traffic.ndim != 3 or traffic.shape[1:] != (n_gpus, n_gpus):
                raise ValueError(
                    f"traffic stack shape {traffic.shape} != "
                    f"(B, {n_gpus}, {n_gpus})")
            totals = traffic.reshape(traffic.shape[0], -1).sum(axis=1)
        else:
            mats = []
            for t in traffic:
                if isinstance(t, Workload):
                    self._check_workload(t)  # same contract as execute()
                    mats.append(t.matrix)
                else:
                    mats.append(np.asarray(t))
            for mat in mats:
                if mat.shape != (n_gpus, n_gpus):
                    raise ValueError(
                        f"traffic matrix shape {mat.shape} != "
                        f"({n_gpus}, {n_gpus})")
            totals = np.array([mat.sum() for mat in mats])
        return [self._result(float(t)) for t in totals]


def _stack_perm_arrays(phases, n: int):
    """Stack the plan's permutation phases (stages and blocks, in order)
    into ``(perms, sizes, slot2d, has_slots)`` arrays for the compiler's
    vectorized pass.  A lone PermutationBlock -- the incremental trajectory
    engine's emission -- passes its arrays through without copying."""
    if len(phases) == 1 and isinstance(phases[0], PermutationBlock):
        b = phases[0]
        perms = np.asarray(b.perms, dtype=np.int64)
        if perms.shape[1:] != (n,):
            raise ValueError(
                f"permutation stages must all have {n} senders to compile "
                f"(got shape {perms.shape})")
        return (perms, np.asarray(b.sizes, dtype=np.float64), b.slot2d(),
                np.full(perms.shape[0], b.slots is not None))
    perms_l, sizes_l, slots_l, has_l = [], [], [], []
    for p in phases:
        if isinstance(p, PermutationBlock):
            if p.n_stages == 0:
                continue
            perms_l.append(np.asarray(p.perms, dtype=np.int64))
            sizes_l.append(np.asarray(p.sizes, dtype=np.float64))
            slots_l.append(p.slot2d())
            has_l.append(np.full(p.n_stages, p.slots is not None))
        else:
            perms_l.append(np.asarray(p.perm, dtype=np.int64)[None, :])
            sizes_l.append(np.array([float(p.size)]))
            slots_l.append(
                (np.asarray(p.slots, dtype=np.float64)
                 if p.slots is not None
                 else np.full(len(p.perm), float(p.size)))[None, :])
            has_l.append(np.array([p.slots is not None]))
    if any(a.shape[-1] != n for a in perms_l):
        raise ValueError(
            f"permutation stages must all have {n} senders to compile "
            f"(got widths {sorted({a.shape[-1] for a in perms_l})})")
    if not perms_l:
        return (np.full((0, n), -1, dtype=np.int64), np.zeros(0),
                np.zeros((0, n)), np.zeros(0, dtype=bool))
    return (np.concatenate(perms_l, axis=0), np.concatenate(sizes_l),
            np.concatenate(slots_l, axis=0), np.concatenate(has_l))


def _last_perm_stage(phases) -> Optional[PermutationStage]:
    """The final (non-empty) permutation stage of the plan -- the shape the
    pipeline-tail redistribute spreads over."""
    for p in reversed(phases):
        if isinstance(p, PermutationBlock):
            if p.n_stages:
                return p.stage_view(p.n_stages - 1)
        else:
            return p
    return None


def _compiled_perm_group(topo: Topology, perms: np.ndarray,
                         sizes: np.ndarray, slot2d: np.ndarray,
                         has_slots: np.ndarray, shares: np.ndarray):
    """One vectorized pass over all permutation stages (stacked arrays
    from ``_stack_perm_arrays``).

    Returns (times, redis) where ``times[k]`` is stage k's link-level
    transfer time (spine included) and ``redis[k]`` its
    hidden-redistribute time -- the padded equivalents of
    ``_perm_stage_time`` / ``_stage_redistribute_time`` with dead senders
    contributing exactly nothing.
    """
    n, m = topo.n_servers, topo.m_gpus
    s_count = perms.shape[0]
    mask, dst, slot2d = live_slots_batch(perms, slot2d)
    live_count = mask.sum(axis=1)

    tx, rx = topo.nic_tx, topo.nic_rx
    a2a = topo.intra_a2a_bw
    rows_idx = np.arange(n)
    times = np.empty(s_count)
    redis = np.empty(s_count)
    block = max(1, _COMPILE_BLOCK_ELEMS // max(n * m, 1))
    for lo in range(0, s_count, block):
        hi = min(s_count, lo + block)
        p_blk = dst[lo:hi]                                   # (b, n)
        sl_blk = slot2d[lo:hi]                               # (b, n)
        rail_caps = np.minimum(tx[None, :, :], rx[p_blk])    # (b, n, m)
        flows = sl_blk[:, :, None] * shares[rows_idx[None, :], p_blk]
        times[lo:hi] = _div(flows, rail_caps).max(axis=(1, 2), initial=0.0)
        redis[lo:hi] = _div(sl_blk / m, a2a[p_blk]).max(axis=1, initial=0.0)

    # Spine: exact blind form (size * live senders) vs per-slot sum.
    spine_bytes = np.where(has_slots, slot2d.sum(axis=1),
                           sizes * live_count)
    times = np.maximum(times, _div(spine_bytes, topo.spine_bandwidth))
    # Padding-only stages: zero transfer (the interpreted path returns
    # before the spine term) but the legacy cluster-min redistribute.
    empty = live_count == 0
    if empty.any():
        times[empty] = 0.0
        redis[empty] = _div(sizes[empty] / m, float(a2a.min()))
    return times, redis


def compile_plan(plan: Plan, topology: Optional[Topology] = None
                 ) -> ExecutableSchedule:
    """Flatten a Plan into an ExecutableSchedule against one Topology.

    All permutation stages (and their hidden redistributes) are timed in
    one padded vectorized pass, barrier stages in another; the remaining
    phase types are one-per-plan and timed directly.  Phase *semantics*
    are identical to the interpreted walk -- this is a change of loop
    structure, not of timing model.  Prefer ``Plan.compile`` (memoized);
    this function always compiles fresh.
    """
    topo = topology if topology is not None else plan.topo
    _check_execution_shape(plan, topo)
    m = topo.m_gpus
    breakdown: Dict[str, float] = {}
    n_stages = 0

    def add(key: str, dt: float) -> None:
        breakdown[key] = breakdown.get(key, 0.0) + dt

    perm_phases = [p for p in plan.phases
                   if isinstance(p, (PermutationStage, PermutationBlock))]
    if perm_phases:
        perms, sizes, slot2d, has_slots = _stack_perm_arrays(
            perm_phases, topo.n_servers)
        if perms.shape[0]:
            shares = _plan_shares(plan, topo)
            times, redis = _compiled_perm_group(topo, perms, sizes, slot2d,
                                                has_slots, shares)
            add("inter", float((times + topo.alpha).sum()))
            # Stage k's redistribute hides under stage k+1's transfer;
            # the `where` keeps inf-vs-inf stages at zero residual exactly
            # like the interpreted `max(0.0, inf - inf)`.
            add("hidden_residual", float(
                np.where(redis[:-1] > times[1:], redis[:-1] - times[1:],
                         0.0).sum()))
            n_stages += int(perms.shape[0])
    last_stage = _last_perm_stage(perm_phases)

    barrier = [p for p in plan.phases if isinstance(p, BarrierStage)]
    if barrier and len({p.sizes.shape for p in barrier}) == 1:
        flows = np.stack([p.sizes for p in barrier])            # (K, N)
        dsts = np.stack([p.dsts for p in barrier]).astype(np.int64)
        src = np.arange(flows.shape[1])
        src_s, src_g = src // m, src % m
        dst_s, dst_g = dsts // m, dsts % m
        same = dst_s == src_s[None, :]
        caps = np.minimum(topo.nic_tx[src_s, src_g][None, :],
                          topo.nic_rx[dst_s, dst_g])
        bw = np.where(same, topo.intra_path_bw[src_s][None, :], caps)
        stage_t = _div(flows, bw).max(axis=1, initial=0.0)
        spine_t = _div(np.where(same, 0.0, flows).sum(axis=1),
                       topo.spine_bandwidth)
        t = np.maximum(stage_t, spine_t)
        if (t > 0).any():  # all-zero groups add no key, like interpreted
            add("inter", float(np.where(t > 0, topo.alpha + t, 0.0).sum()))
        n_stages += len(barrier)
        barrier = []  # consumed by the batched pass

    for ph in plan.phases:
        if isinstance(ph, (PermutationStage, PermutationBlock)):
            continue  # timed collectively above
        if isinstance(ph, BarrierStage):
            if barrier:  # ragged fallback: stages of mismatched width
                stage = _barrier_time(topo, ph)
                if stage > 0:
                    add("inter", topo.alpha + stage)
                n_stages += 1
        elif isinstance(ph, IntraOverlapPhase):
            pass  # resolved against the final inter total below
        else:
            n_stages += _simple_phase_time(topo, ph, last_stage, add)

    for ph in plan.phases:
        if isinstance(ph, IntraOverlapPhase):
            add("intra_residual",
                _overlap_residual_time(topo, ph, breakdown.get("inter",
                                                               0.0)))

    return ExecutableSchedule(
        plan=plan,
        topology=topo,
        completion_time=max(sum(breakdown.values()), 1e-30),
        breakdown=MappingProxyType(breakdown),
        n_stages=n_stages,
    )


def execute_plan(plan: Plan, w: Workload, *,
                 topology: Optional[Topology] = None,
                 reference: bool = False) -> SimResult:
    """Time a Plan against a Topology's link-level resources.

    Phase semantics are dispatched on phase *type* (see module docstring);
    overlap phases (IntraOverlapPhase) are resolved against the inter
    phase's duration after all stages are timed.  The breakdown always sums
    to completion_time.

    Execution goes through the compiled path: the plan's memoized
    ``ExecutableSchedule`` (compiled on first use per execution topology)
    accounts the workload in O(1) beyond the matrix byte total -- repeated
    execution of a cached plan stops paying O(stages) Python per call.

    Args:
      plan: the synthesized schedule.
      w: the workload (total-bytes accounting).
      topology: execution fabric override.  Default: the topology the plan
        was synthesized for.  Passing a different (same-shape) fabric times
        a topology-blind schedule on the real degraded/heterogeneous
        fabric.
      reference: run the original interpreted per-phase walk instead (the
        parity oracle; no compilation, no memoization).
    """
    if reference:
        return _execute_plan_interpreted(plan, w, topology=topology)
    return plan.compile(topology).execute(w)


def _check_plan_algorithm(plan: Plan, algorithm: str) -> None:
    if plan.algorithm != algorithm:
        raise ValueError(
            f"plan was synthesized by {plan.algorithm!r}, asked to "
            f"execute as {algorithm!r}")


def _check_plan_fabric(plan: Plan, w: Workload) -> None:
    if plan.topo.fingerprint() != w.topo.fingerprint():
        raise ValueError(
            "plan was synthesized for a different fabric than the "
            "workload's topology (stale plan after a fabric change?); "
            "re-synthesize, or pass topology= explicitly to time the "
            "blind schedule on the new fabric")


def _seed_cache(plan: Plan, cache: Optional[PlanCache]) -> None:
    """A pre-synthesized plan handed to a cached call seeds the cache
    under the plan's *own* traffic fingerprint, so replaying the traffic
    it was synthesized for hits from now on.  (Keying by the executed
    workload would poison the cache in drift experiments, where a stale
    plan is deliberately executed against new traffic.)"""
    if cache is not None and plan.fingerprint is not None:
        cache.insert(plan.fingerprint, plan)


def _resolve_plan(w: Workload, algorithm: str, plan: Optional[Plan],
                  cache: Optional[PlanCache],
                  topology: Optional[Topology]) -> Plan:
    """Shared synthesis/lookup front half of simulate / simulate_many."""
    if plan is None:
        scheduler = get_scheduler(algorithm)
        if cache is not None:
            return cache.get_or_synthesize(scheduler, w)
        return scheduler.synthesize(w)
    _check_plan_algorithm(plan, algorithm)
    if topology is None:
        _check_plan_fabric(plan, w)
    _seed_cache(plan, cache)
    return plan


def simulate(
    w: Workload,
    algorithm: str,
    *,
    plan: Optional[Plan] = None,
    cache: Optional[PlanCache] = None,
    topology: Optional[Topology] = None,
    reference: bool = False,
) -> SimResult:
    """Scheduler -> Plan -> Executor, in one call.

    Args:
      w: the GPU-level workload (its ``topo`` drives synthesis).
      algorithm: registry name (see available_schedulers()).
      plan: pre-synthesized Plan to execute (skips synthesis entirely).
        With ``cache=`` it is also inserted under its own traffic
        fingerprint so later replays of that traffic hit.
      cache: optional PlanCache; on a repeated (traffic, topology)
        fingerprint the cached Plan -- with its compiled schedule already
        attached -- is executed without re-synthesis (hit/miss counters on
        the cache record the reuse rate).
      topology: execution fabric override (see ``execute_plan``): times the
        plan on a fabric other than the one it was synthesized for.
      reference: time via the interpreted oracle executor.
    """
    plan = _resolve_plan(w, algorithm, plan, cache, topology)
    return execute_plan(plan, w, topology=topology, reference=reference)


def simulate_many(
    workloads: Sequence[Workload],
    algorithm: str,
    *,
    plan: Optional[Plan] = None,
    cache: Optional[PlanCache] = None,
    topology: Optional[Topology] = None,
    reference: bool = False,
    fuse: bool = False,
) -> List[SimResult]:
    """Batched front door: time a trajectory of workloads in order.

    The serving-loop pipeline (paper: "traffic shifts every few hundred
    milliseconds") per element: cache lookup (exact hit -> cached plan with
    its compiled schedule attached; near-miss -> warm repair when the cache
    enables it) -> compiled execution.  Runs of consecutive workloads that
    resolve to the *same* plan are accounted through one
    ``ExecutableSchedule.execute_batch`` call.  Equivalent to
    ``[simulate(w, algorithm, ...) for w in workloads]`` result-for-result
    (regression-tested), minus the per-iteration executor overhead.

    Args:
      workloads: the traffic trajectory, in serving order.
      plan: hold one pre-synthesized Plan for the whole trajectory (the
        drift experiment: how does a stale schedule fare as traffic moves).
      fuse: synthesize the whole trajectory up front through the
        scheduler's ``synthesize_trajectory`` (FLASH: incremental
        delta-decomposition chained across adjacent matrices) instead of
        resolving plans one by one; the fused plans also seed ``cache``.
        Ignored when the scheduler does not fuse or ``plan`` is held.
    """
    workloads = list(workloads)
    fused: Optional[List[Plan]] = None
    if fuse and plan is None:
        scheduler = get_scheduler(algorithm)
        if hasattr(scheduler, "synthesize_trajectory"):
            fused = scheduler.synthesize_trajectory(workloads)
            for p in fused:
                _seed_cache(p, cache)
    if reference:
        return [simulate(w, algorithm,
                         plan=fused[i] if fused is not None else plan,
                         cache=cache, topology=topology, reference=True)
                for i, w in enumerate(workloads)]
    results: List[Optional[SimResult]] = [None] * len(workloads)
    run_sched: Optional[ExecutableSchedule] = None
    run_idx: List[int] = []

    def flush() -> None:
        if run_sched is not None and run_idx:
            batch = run_sched.execute_batch(
                [workloads[i] for i in run_idx])
            for i, r in zip(run_idx, batch):
                results[i] = r
        run_idx.clear()

    if plan is not None:
        # Loop-invariant for a held plan: check and seed the cache once,
        # not once per trajectory element.
        _check_plan_algorithm(plan, algorithm)
        _seed_cache(plan, cache)
    for i, w in enumerate(workloads):
        if plan is not None:
            if topology is None:
                _check_plan_fabric(plan, w)
            p = plan
        elif fused is not None:
            p = fused[i]
        else:
            p = _resolve_plan(w, algorithm, None, cache, topology)
        sched = p.compile(topology)
        if sched is not run_sched:
            flush()
            run_sched = sched
        run_idx.append(i)
    flush()
    return results  # type: ignore[return-value]


class _AlgorithmView(Mapping):
    """Live name -> simulate-callable view over the scheduler registry
    (back-compat for the seed's ALGORITHMS dict)."""

    def __iter__(self) -> Iterator[str]:
        return iter(SCHEDULERS)

    def __len__(self) -> int:
        return len(SCHEDULERS)

    def __getitem__(self, name: str):
        if name not in SCHEDULERS:
            raise KeyError(name)

        def run(w: Workload, **kw) -> SimResult:
            return simulate(w, name, **kw)

        return run


ALGORITHMS = _AlgorithmView()
