"""All-to-All schedulers: FLASH and the paper's baselines, as Plan synthesis.

Every scheduler is a ``Scheduler`` subclass behind the ``register_scheduler``
registry.  ``Scheduler.synthesize`` consumes a GPU-level ``Workload`` and
produces a scheduler-agnostic ``Plan`` (core/plan.py) that the single
generic alpha-beta executor (simulator.py) times -- adding an algorithm
means adding one class here, never forking the simulator.

  * flash        -- the paper's contribution: intra load balance, then the
                    ascending Birkhoff stage list of the server-level
                    matrix (PermutationStages), redistribute tail hidden
                    under the pipeline.
  * fanout       -- RCCL default: every GPU transmits to all peers at once
                    (one FanOutBurst; incast is the burst's property).
  * spreadout    -- MPI: N-1 barrier-synchronized stages, stage k pairs
                    g -> (g + k) mod N (BarrierStages; stragglers are the
                    barrier's property).
  * hierarchical -- MSCCL-style rail-aligned: GPU i of each server
                    aggregates local traffic for rail-i peers, then ships
                    it over NIC i (gather head + RailStage + scatter tail).
  * optimal      -- Theorem 1 bound (BoundStage; the 'optimal' line in
                    every figure).

``flash_schedule`` survives as a numeric-parity shim returning the legacy
``FlashPlan`` view of the synthesized Plan.
"""

from __future__ import annotations

import abc
import dataclasses
import time
from typing import ClassVar, Dict, List, Optional, Tuple, Type

import numpy as np

from ..analysis.locks import check_forbidden
from .birkhoff import (
    AUTO_EXACT_MAX_N,
    DecompositionState,
    Stage,
    birkhoff_decompose,
    effective_pair_caps,
    max_line_sum,
    stage_duration,
)
from .plan import (
    BarrierStage,
    BoundStage,
    FanOutBurst,
    IntraOverlapPhase,
    LoadBalancePhase,
    PermutationBlock,
    PermutationStage,
    Plan,
    RailStage,
    RedistributePhase,
    traffic_fingerprint,
)
from .topology import uniform_nic_shares
from .traffic import ClusterSpec, Workload

__all__ = [
    "Scheduler",
    "register_scheduler",
    "get_scheduler",
    "available_schedulers",
    "SCHEDULERS",
    "RepairConfig",
    "FlashScheduler",
    "CapacityAwareFlashScheduler",
    "FanOutScheduler",
    "SpreadOutScheduler",
    "HierarchicalScheduler",
    "OptimalScheduler",
    "FlashPlan",
    "flash_schedule",
    "spreadout_stages",
    "hierarchical_nic_loads",
    "optimal_completion_time",
    "synthesis_time",
]


# -- registry --------------------------------------------------------------

SCHEDULERS: Dict[str, Type["Scheduler"]] = {}


def register_scheduler(cls: Type["Scheduler"]) -> Type["Scheduler"]:
    """Class decorator: registers ``cls`` under ``cls.name``."""
    if not getattr(cls, "name", None):
        raise ValueError(f"{cls.__name__} must define a class-level `name`")
    SCHEDULERS[cls.name] = cls
    return cls


def get_scheduler(name: str) -> "Scheduler":
    try:
        return SCHEDULERS[name]()
    except KeyError:
        raise ValueError(
            f"unknown algorithm {name!r}; pick from {sorted(SCHEDULERS)}")


def available_schedulers() -> List[str]:
    return sorted(SCHEDULERS)


class Scheduler(abc.ABC):
    """Base class: synthesize a Plan from a Workload.

    Subclasses implement ``plan_phases`` returning (phases,
    extra_memory_bytes); the base wraps them into a Plan with synthesis
    wall-time (the paper's 'scheduling time' metric, Fig 17a) and the
    traffic fingerprint used by PlanCache.
    """

    name: ClassVar[str] = ""
    accounts_intra: ClassVar[bool] = True

    @abc.abstractmethod
    def plan_phases(self, w: Workload) -> Tuple[tuple, float]:
        """Return (phases, extra_memory_bytes) or (phases,
        extra_memory_bytes, nic_shares) for topology-aware schedulers."""
        ...

    def synthesize(self, w: Workload,
                   fingerprint: Optional[str] = None) -> Plan:
        check_forbidden("synthesize")
        t0 = time.perf_counter()
        out = self.plan_phases(w)
        synth = time.perf_counter() - t0
        return self._build_plan(w, out, synth, fingerprint)

    def synthesize_bounded(self, w: Workload, budget_seconds:
                           Optional[float] = None,
                           fingerprint: Optional[str] = None
                           ) -> Tuple[Plan, bool]:
        """Synthesize under a soft wall-clock budget: ``(plan, exact)``.

        The serving daemon's cold path must answer *now*, not after the
        best possible synthesis -- so a scheduler may trade plan quality
        for latency when its predicted synthesis cost exceeds the budget,
        returning ``exact=False`` to signal that a background upgrade to
        the unbounded plan is worthwhile.  The base implementation has no
        degraded mode (every baseline synthesizes in O(n) -- the budget
        cannot bind), so it always returns the exact plan; FLASH overrides
        this with the fast repair-engine decomposition.
        """
        del budget_seconds  # no degraded mode: the exact plan is the answer
        return self.synthesize(w, fingerprint=fingerprint), True

    def _build_plan(self, w: Workload, out, synth: float,
                    fingerprint: Optional[str]) -> Plan:
        """Wrap a ``plan_phases``-shaped result into a Plan (shared by the
        cold synthesize and warm repair paths)."""
        phases, extra_mem = out[0], out[1]
        nic_shares = out[2] if len(out) > 2 else None
        # Fingerprint hashing (O(matrix bytes)) stays outside the timed
        # window: synth_seconds is the paper's Fig 17a synthesis metric.
        if fingerprint is None:
            fingerprint = traffic_fingerprint(w, self.name)
        return Plan(
            algorithm=self.name,
            cluster=w.cluster,
            phases=tuple(phases),
            synth_seconds=synth,
            extra_memory_bytes=float(extra_mem),
            accounts_intra=self.accounts_intra,
            fingerprint=fingerprint,
            topology=w.topology,
            nic_shares=nic_shares,
            capacity_aware=getattr(self, "capacity_aware", False),
        )


# -- FLASH -----------------------------------------------------------------

@dataclasses.dataclass(frozen=True)
class RepairConfig:
    """Tunable knobs for warm-started repair (``try_repair_plan``).

    The ratchet thresholds decide when a repair is *not* a near-miss and
    the caller should cold-synthesize instead:

      * ``max_residual_fraction`` -- bail when more than this fraction of
        the new traffic falls outside the previous plan's permutations.
      * ``max_stage_drift`` -- bail when chained repairs stretch the stage
        list past this multiple of the Birkhoff bound (n^2 - 2n + 2).
      * ``quality_ratchet`` -- incremental engine only: bail when the
        repaired stage windows sum to more than this multiple of the exact
        lower bound (the completion-time audit of DESIGN.md 1f).
      * ``headroom`` -- incremental engine only: extra slack (fraction of
        each pair's traffic) on the last slot of every pair, absorbing
        traffic *growth* without structural change.
      * ``incremental`` -- route repair through the stateful
        ``DecompositionState`` delta engine (default); False falls back to
        the legacy one-shot refill loop, which re-walks the previous stage
        list per miss and carries no state (the CI speedup baseline).
    """

    max_residual_fraction: float = 0.25
    max_stage_drift: float = 2.0
    quality_ratchet: float = 1.10
    headroom: float = 0.5
    incremental: bool = True

    def for_topology_change(self) -> "RepairConfig":
        """Relaxed copy for cross-fabric re-repair (fault events).

        The quality ratchet prices drift against a *fixed* fabric's lower
        bound; after a degrade/fail event the old stage structure is
        necessarily a little off the new fabric's optimum, and the serving
        contract is degraded-but-valid-now with an exact re-synthesis
        upgrading it in the background.  Floor the ratchet so a bounded
        mismatch does not force every family cold at once."""
        floor = TOPOLOGY_CHANGE_QUALITY_RATCHET
        if self.quality_ratchet >= floor:
            return self
        return dataclasses.replace(self, quality_ratchet=floor)


# A re-repaired plan may run up to this multiple of the new fabric's exact
# lower bound before the repair is rejected as not-worth-keeping (the
# fig_fault CI guard asserts the *measured* post-event completion stays
# well inside this against a cold synthesis on the degraded fabric).
TOPOLOGY_CHANGE_QUALITY_RATCHET = 1.75

DEFAULT_REPAIR_CONFIG = RepairConfig()

# Stash attribute for the DecompositionState a repaired plan carries to
# the next miss of its family.  Plans are frozen dataclasses, so the state
# rides in __dict__ via object.__setattr__ and is *claimed* (popped) by
# exactly one successor -- dict.pop is atomic under the GIL, so concurrent
# daemon misses cannot share one state's mutable structure.
_STATE_ATTR = "_decomp_state"


@register_scheduler
class FlashScheduler(Scheduler):
    """Three-phase, two-tier FLASH schedule (paper 4.2-4.3).

    This is the code path whose latency the paper reports as ~15-32 us on
    small clusters; it is pure NumPy + Hopcroft-Karp and runs per iteration
    on the host control thread (paper Fig 10).
    """

    name = "flash"
    accounts_intra = True
    # Synthesize the Birkhoff stages against the fabric's pair capacities
    # (time-domain decomposition, per-sender slots).  Off here: "flash"
    # stays bit-identical to the capacity-blind engine; the "flash_ca"
    # registration below is the opt-in.
    capacity_aware: ClassVar[bool] = False

    def plan_phases(self, w: Workload):
        return self._plan_phases(w, policy="auto")

    def _plan_phases(self, w: Workload, policy: str):
        t_server, s_intra, _ = w.reductions()
        stages = birkhoff_decompose(
            t_server, sort_ascending=True, coalesce=True, policy=policy,
            topology=w.topo if self.capacity_aware else None,
            capacity_aware=self.capacity_aware)
        return self._phases_from_stages(w, t_server, s_intra, stages)

    # Observed cold-synthesis seconds per (algorithm, n_servers), EWMA.
    # Class-level so every scheduler instance (the serving daemon builds
    # them on demand) shares one latency model; keys include the name so
    # flash and flash_ca never mix.
    _synth_ewma: ClassVar[Dict[Tuple[str, int], float]] = {}

    def synthesize_bounded(self, w: Workload, budget_seconds:
                           Optional[float] = None,
                           fingerprint: Optional[str] = None
                           ) -> Tuple[Plan, bool]:
        """FLASH under a latency budget (see ``Scheduler.synthesize_bounded``).

        The cost model is an EWMA of observed cold-synthesis times for
        this (algorithm, n_servers); when the estimate exceeds the budget
        the decomposition runs with ``policy="repair"`` -- the augmenting
        path engine that is the fast mode beyond ``AUTO_EXACT_MAX_N``
        servers -- instead of the default auto policy.  Below that size
        the repair engine produces a valid but generally different (and
        slightly longer) stage list than the exact engine, so the plan is
        flagged inexact and the serving daemon schedules a background
        upgrade; at or beyond it the repair engine *is* what unbounded
        synthesis runs, so the degraded path is already exact.
        """
        key = (self.name, w.cluster.n_servers)
        est = self._synth_ewma.get(key)
        if budget_seconds is None or est is None or est <= budget_seconds:
            plan = self.synthesize(w, fingerprint=fingerprint)
            obs = plan.synth_seconds
            self._synth_ewma[key] = obs if est is None \
                else 0.7 * est + 0.3 * obs
            return plan, True
        t0 = time.perf_counter()
        out = self._plan_phases(w, policy="repair")
        plan = self._build_plan(w, out, time.perf_counter() - t0,
                                fingerprint)
        return plan, w.cluster.n_servers > AUTO_EXACT_MAX_N

    def _lb_phase(self, w: Workload, t_server: np.ndarray):
        """Load-balance phase shared by the stage-list and stage-block plan
        builders: per (server, gpu), how many bytes must this GPU shed so
        that every local GPU holds exactly its rail's share of T[a, j] for
        every dest j?  Shares are proportional to rail capacity, min(src
        NIC, dst NIC) per rail (topology-aware rebalance): on a homogeneous
        fabric this is the paper's uniform T/m split; with degraded or
        mixed-speed NICs the fast rails carry more so every rail of a pair
        drains simultaneously.  Homogeneous fabrics share the memoized
        uniform array instead of recomputing the capacity mins on every
        synthesis (serving-loop hot path)."""
        n, m = w.cluster.n_servers, w.cluster.m_gpus
        homog = w.topo.is_homogeneous
        shares = (uniform_nic_shares(n, m) if homog
                  else w.topo.nic_shares())  # (n, n, m): [src, dst, rail]
        per_gpu_dest = w.reductions()[2]  # (n, m, n)
        if homog:
            # Uniform shares are 1/m everywhere: a scalar broadcast beats
            # the elementwise product with the transposed (n, m, n) view.
            target = t_server[:, None, :] * (1.0 / m)
        else:
            target = t_server[:, None, :] * shares.transpose(0, 2, 1)
        excess = per_gpu_dest - target
        np.maximum(excess, 0.0, out=excess)
        excess[np.arange(n), :, np.arange(n)] = 0.0  # intra not balanced
        lb_moved = excess.sum(axis=2)  # (n, m) total bytes each GPU sheds
        return LoadBalancePhase(moved_per_gpu=lb_moved,
                                charge_alpha=True), shares, lb_moved

    def _phases_from_stages(self, w: Workload, t_server: np.ndarray,
                            s_intra: np.ndarray, stages):
        """Wrap a Birkhoff stage list (cold-synthesized or warm-repaired)
        into the three-phase FLASH plan for workload ``w``."""
        m = w.cluster.m_gpus
        lb, shares, lb_moved = self._lb_phase(w, t_server)
        phases = [lb]
        phases += [PermutationStage(perm=s.perm, size=s.size, sent=s.sent,
                                    slots=s.slots)
                   for s in stages]
        if stages:
            phases.append(RedistributePhase(
                bytes_per_gpu=stages[-1].size / m, charge_alpha=True))
        phases.append(IntraOverlapPhase(per_server=s_intra))

        inter_bytes = float(sum(s.real_bytes for s in stages))
        # Staging beyond 2x send/recv: load-balance + redistribute buffers
        # (the measured ~2.6x slope of Fig 17b).
        extra_mem = float(lb_moved.sum()) + inter_bytes / m
        # Uniform shares are the executor's fallback: carrying a dense
        # (n, n, m) array on every homogeneous plan would only bloat the
        # PlanCache and JSON wire format.
        if w.topo.is_homogeneous:
            return tuple(phases), extra_mem
        return tuple(phases), extra_mem, shares

    def _phases_from_block(self, w: Workload, t_server: np.ndarray,
                           s_intra: np.ndarray, block):
        """Stage-block counterpart of ``_phases_from_stages``: wrap one
        ``StageBlock`` emission of the incremental engine as a single
        ``PermutationBlock`` phase, keeping its stacked arrays intact (no
        per-stage object materialization on the repair hot path)."""
        m = w.cluster.m_gpus
        lb, shares, lb_moved = self._lb_phase(w, t_server)
        phases = [lb]
        inter_bytes = 0.0
        if len(block):
            phases.append(PermutationBlock(
                perms=block.perms, sizes=block.sizes, sent=block.sent,
                slots=block.slots))
            phases.append(RedistributePhase(
                bytes_per_gpu=float(block.sizes[-1]) / m, charge_alpha=True))
            # The emitted block conserves the inter-server matrix exactly
            # (refill + residual = T); summing the small matrix beats
            # summing the (S, n) sent array.
            inter_bytes = float(t_server.sum())
        phases.append(IntraOverlapPhase(per_server=s_intra))
        extra_mem = float(lb_moved.sum()) + inter_bytes / m
        if w.topo.is_homogeneous:
            return tuple(phases), extra_mem
        return tuple(phases), extra_mem, shares

    # Default repair knobs; instances (or the serving daemon) may override
    # with ``sched.repair_config = RepairConfig(...)``.
    repair_config: ClassVar[Optional[RepairConfig]] = None

    def try_repair_plan(self, prev: Plan, w: Workload,
                        fingerprint: Optional[str] = None, *,
                        config: Optional[RepairConfig] = None,
                        stats: Optional[dict] = None,
                        topology_change: bool = False) -> Optional[Plan]:
        """Warm-started re-synthesis: seed the new plan with the previous
        plan's permutations instead of a cold Birkhoff decomposition.

        The near-miss path for dynamic MoE (paper Fig 4): when traffic
        shifts a little between iterations, the old stage list is almost
        right -- so the previous stages' slots are refilled with the new
        matrix's bytes (capped by slot size) and only the residual that did
        not fit is decomposed fresh.  A small shift therefore costs a fill
        pass plus a tiny decomposition instead of a full synthesis.  The
        result is a valid FLASH plan (byte-conserving, incast-free) but
        generally a different -- and slightly longer -- stage list than
        cold synthesis; PlanCache only takes this path when explicitly
        enabled (``warm_start=True``).

        Two engines sit behind this entry point, selected by
        ``config.incremental`` (see ``RepairConfig``): the stateful
        ``DecompositionState`` delta engine, which carries the decomposition
        structure from plan to plan so consecutive misses of a family pay
        only the drift delta, and the legacy one-shot loop that re-walks
        ``prev``'s stage list each call.  ``stats``, when passed, is filled
        with the engine's audit record (mode, residual_fraction, and on the
        incremental path n_stages/quality or the tripped ratchet).

        Returns None when the shift is no near-miss (the caller should
        cold-synthesize): too much traffic falls outside the old
        permutations, chained repairs would drift far past the Birkhoff
        stage bound, or the incremental quality ratchet tripped.

        ``topology_change=True`` relaxes the fabric-fingerprint match for
        fault-tolerant re-repair: ``prev`` was synthesized on a different
        (pre-event) topology of the same shape, and its stage structure is
        re-repaired against ``w.topo``'s *new* pair capacities -- the
        carried delta state is discarded (its water-fill thresholds embed
        the old fabric's capacities) and rebuilt fresh from the plan's
        phases, so shares, slots and validation all reflect the degraded
        or recovered fabric.
        """
        if prev.algorithm != self.name:
            raise ValueError(
                f"cannot warm-start {self.name!r} from a {prev.algorithm!r} "
                "plan")
        if prev.cluster != w.cluster:
            raise ValueError(
                "warm-start requires the previous plan's cluster to match "
                "the new workload's")
        if not topology_change and \
                prev.topo.fingerprint() != w.topo.fingerprint():
            raise ValueError(
                "warm-start requires the previous plan's (cluster, "
                "topology) to match the new workload's fabric; pass "
                "topology_change=True to re-repair across a fabric event")
        cfg = config if config is not None else \
            (self.repair_config or DEFAULT_REPAIR_CONFIG)
        if topology_change:
            # Any carried state is priced in the old fabric's capacities;
            # drop it so neither this repair nor a later claim reuses it.
            prev.__dict__.pop(_STATE_ATTR, None)
            cfg = cfg.for_topology_change()
            if stats is not None:
                stats["topology_change"] = True
        # Like fingerprint hashing (see _build_plan), the O(gpu-matrix)
        # reduction is input normalization shared with execution and
        # fingerprinting, not synthesis: memoized on the workload and kept
        # outside the timed window.
        t_server, s_intra, _ = w.reductions()
        t0 = time.perf_counter()
        if cfg.incremental:
            return self._repair_incremental(prev, w, t_server, s_intra, cfg,
                                            stats, t0, fingerprint)
        return self._repair_oneshot(prev, w, t_server, s_intra, cfg,
                                    stats, t0, fingerprint)

    def _claim_state(self, prev: Plan) -> Optional[DecompositionState]:
        """Pop the carried DecompositionState off ``prev``, if it has one
        this scheduler can reuse.  Popping (not reading) makes the handoff
        exclusive: one successor plan inherits the mutable structure."""
        state = prev.__dict__.pop(_STATE_ATTR, None)
        if state is None or state.invalid:
            return None
        if state.n != prev.cluster.n_servers or \
                state.aware != self.capacity_aware:
            return None
        return state

    def _state_from_plan(self, prev: Plan,
                         w: Workload, headroom: float
                         ) -> Optional[DecompositionState]:
        """Rebuild a DecompositionState from ``prev``'s permutation phases
        (the cold-plan bootstrap: a freshly synthesized plan carries no
        state, only stages)."""
        # Batch the per-stage tuples into single np.array calls: a cold
        # 32-server plan carries ~n^2 PermutationStage rows, and one
        # stacked conversion is ~20x cheaper than a per-phase
        # asarray+concatenate chain.
        perm_rows, sent_rows = [], []
        perms_l, sent_l = [], []
        for p in prev.phases:
            if isinstance(p, PermutationStage):
                perm_rows.append(p.perm)
                sent_rows.append(p.sent)
            elif isinstance(p, PermutationBlock):
                if p.n_stages:
                    perms_l.append(np.asarray(p.perms, dtype=np.int64))
                    sent_l.append(np.asarray(p.sent, dtype=np.float64))
        if perm_rows:
            perms_l.append(np.array(perm_rows, dtype=np.int64))
            sent_l.append(np.array(sent_rows, dtype=np.float64))
        if not perms_l:
            return None
        caps_eff = (effective_pair_caps(w.topo.pair_capacity())
                    if self.capacity_aware else None)
        return DecompositionState(
            np.concatenate(perms_l, axis=0), np.concatenate(sent_l, axis=0),
            caps_eff=caps_eff, headroom=headroom)

    def seed_repair_state(self, plan: Plan, w: Workload, *,
                          config: Optional[RepairConfig] = None) -> None:
        """Attach a fresh ``DecompositionState`` to a cold-synthesized plan
        so the family's *first* warm repair already runs the delta path.

        The state rebuild is the one per-family bootstrap cost of the
        incremental engine (stacking ~n^2 stage tuples into arrays and
        indexing them); paying it here, alongside the cold decomposition it
        derives from, keeps every subsequent miss at delta cost.  Safe to
        skip -- ``try_repair_plan`` rebuilds lazily when no state rides the
        previous plan."""
        cfg = config if config is not None else \
            (self.repair_config or DEFAULT_REPAIR_CONFIG)
        state = self._state_from_plan(plan, w, cfg.headroom)
        if state is not None:
            object.__setattr__(plan, _STATE_ATTR, state)

    def _repair_incremental(self, prev, w, t_server, s_intra, cfg, stats,
                            t0, fingerprint) -> Optional[Plan]:
        state = self._claim_state(prev)
        if state is None:
            state = self._state_from_plan(prev, w, cfg.headroom)
            if state is None:
                return None  # prev carries zero traffic: nothing to refill
        block, st = state.update(
            t_server,
            max_residual_fraction=cfg.max_residual_fraction,
            max_stage_drift=cfg.max_stage_drift,
            quality_ratchet=cfg.quality_ratchet)
        if stats is not None:
            stats.update(st)
        if block is None:  # a ratchet tripped; state is dead
            return None
        out = self._phases_from_block(w, t_server, s_intra, block)
        plan = self._build_plan(w, out, time.perf_counter() - t0,
                                fingerprint)
        # Hand the (still valid) state to the new plan: the family's next
        # miss chains through it instead of rebuilding from phases.
        object.__setattr__(plan, _STATE_ATTR, state)
        return plan

    def _repair_oneshot(self, prev, w, t_server, s_intra, cfg, stats,
                        t0, fingerprint) -> Optional[Plan]:
        """Legacy stateless repair: re-walk ``prev``'s stage list, refill
        each slot, decompose the residual.  Kept as the CI baseline the
        incremental engine is measured against, and as the
        ``incremental=False`` escape hatch."""
        n = w.cluster.n_servers
        if stats is not None:
            stats["mode"] = "oneshot"
        remaining = t_server.copy()
        reused = []
        prev_stages: list = []
        for ph in prev.phases:
            if isinstance(ph, PermutationStage):
                prev_stages.append(ph)
            elif isinstance(ph, PermutationBlock):
                # A block plan (incremental engine output) repairs fine
                # one-shot too; expand to per-stage views for the loop.
                prev_stages.extend(ph.iter_stages())
        for p in prev_stages:
            perm = np.asarray(p.perm, dtype=np.int64)
            li = np.flatnonzero(perm >= 0)
            lj = perm[li]
            cap_slot = (np.asarray(p.slots, dtype=np.float64)[li]
                        if p.slots is not None else p.size)
            take = np.minimum(remaining[li, lj], cap_slot)
            remaining[li, lj] -= take
            # The slot only needs to fit the largest refilled payload:
            # shrinking it sheds the padding a traffic *decrease* left
            # behind (an increase lands in the residual decomposition).
            size = float(take.max(initial=0.0))
            if size <= 0.0:  # stage carries nothing anymore: drop it
                continue
            sent = np.zeros(n)
            sent[li] = take
            slots = None
            if self.capacity_aware:
                # Re-weight on repair: every pair's slot shrinks to its
                # refilled payload, so the stage window is set by the
                # slowest refilled pair, not the old padding.
                slot_arr = np.zeros(n)
                slot_arr[li] = take
                slots = tuple(slot_arr.tolist())
            reused.append(Stage(perm=p.perm, size=size,
                                sent=tuple(sent.tolist()), slots=slots))
        res_frac = float(remaining.sum()) / max(float(t_server.sum()), 1.0)
        if stats is not None:
            stats["residual_fraction"] = res_frac
        if res_frac > cfg.max_residual_fraction:
            # Too much traffic fell outside the old permutations: a
            # repaired plan would be far from the cold optimum.
            if stats is not None:
                stats["tripped"] = "residual"
            return None
        if self.capacity_aware:
            residual = birkhoff_decompose(remaining, sort_ascending=True,
                                          coalesce=True, topology=w.topo,
                                          capacity_aware=True)
            # Ascending *durations* preserve the Theorem 2 pipeline on the
            # heterogeneous fabric (byte sizes alone order it wrongly when
            # pair capacities differ).
            caps = w.topo.pair_capacity()
            stages = sorted(reused + residual,
                            key=lambda s: stage_duration(s, caps))
        else:
            residual = birkhoff_decompose(remaining, sort_ascending=True,
                                          coalesce=True)
            stages = sorted(reused + residual, key=lambda s: s.size)
        if stats is not None:
            stats["n_stages"] = len(stages)
        if len(stages) > cfg.max_stage_drift * (n * n - 2 * n + 2):
            # Chained repairs accumulate residual slivers; reset before the
            # stage count (and its per-stage wakeup cost) drifts.
            if stats is not None:
                stats["tripped"] = "stages"
            return None
        out = self._phases_from_stages(w, t_server, s_intra, stages)
        return self._build_plan(w, out, time.perf_counter() - t0,
                                fingerprint)

    def repair_plan(self, prev: Plan, w: Workload,
                    fingerprint: Optional[str] = None, *,
                    config: Optional[RepairConfig] = None) -> Plan:
        """``try_repair_plan`` with a cold-synthesis fallback: always
        returns a valid plan for ``w`` (repaired on a near-miss, fresh
        otherwise)."""
        plan = self.try_repair_plan(prev, w, fingerprint=fingerprint,
                                    config=config)
        if plan is None:
            plan = self.synthesize(w, fingerprint=fingerprint)
        return plan

    def synthesize_trajectory(self, workloads, *,
                              config: Optional[RepairConfig] = None
                              ) -> List[Plan]:
        """Fuse synthesis across a whole traffic window (dynamic MoE
        serving, paper Fig 4): cold-synthesize the first workload, then
        chain every subsequent one through the incremental repair engine,
        so the window pays one full decomposition plus per-step deltas.

        Repeated matrices (MoE traffic revisits signatures) are answered
        from a fingerprint memo without re-synthesis and without disturbing
        the repair chain -- the carried state keeps tracking the newest
        *fresh* matrix.  When a repair ratchet trips mid-window the step
        falls back to cold synthesis and the chain restarts from it.

        Returns one Plan per workload, aligned with the input; repeats
        share the same Plan object.
        """
        cfg = config if config is not None else \
            (self.repair_config or DEFAULT_REPAIR_CONFIG)
        plans: List[Plan] = []
        memo: Dict[str, Plan] = {}
        head: Optional[Plan] = None  # newest structurally-fresh plan
        for w in workloads:
            key = traffic_fingerprint(w, self.name)
            plan = memo.get(key)
            if plan is None:
                if head is not None:
                    plan = self.try_repair_plan(head, w, fingerprint=key,
                                                config=config)
                if plan is None:
                    plan = self.synthesize(w, fingerprint=key)
                    if cfg.incremental:
                        self.seed_repair_state(plan, w, config=cfg)
                memo[key] = plan
                head = plan
            plans.append(plan)
        return plans


@register_scheduler
class CapacityAwareFlashScheduler(FlashScheduler):
    """FLASH with capacity-aware Birkhoff synthesis (opt-in, ``flash_ca``).

    Same three-phase plan shape as ``flash``, but the stage list comes from
    the time-domain decomposition of ``T / pair_capacity`` with
    high-capacity-first matchings (birkhoff.py module docstring): each
    pair's byte slot is sized so every pair of a stage drains in the same
    window, and stages sort by ascending duration.  On a uniform-capacity
    fabric the decomposition degenerates to the blind one, so this
    scheduler only diverges from ``flash`` where pair capacities differ
    (degraded NICs, mixed NIC generations).  Registered under its own name
    so plans, cache families and warm repairs never mix with the blind
    engine's.
    """

    name = "flash_ca"
    capacity_aware = True


# -- FanOut ----------------------------------------------------------------

@register_scheduler
class FanOutScheduler(Scheduler):
    """RCCL default: zero synthesis, one burst of the whole matrix."""

    name = "fanout"
    accounts_intra = True

    def plan_phases(self, w: Workload):
        return (FanOutBurst(matrix=np.array(w.matrix, dtype=np.float64)),), \
            0.0


# -- SpreadOut -------------------------------------------------------------

@register_scheduler
class SpreadOutScheduler(Scheduler):
    """MPI SpreadOut: N-1 barrier stages, stage k pairs g -> (g+k) mod N."""

    name = "spreadout"
    accounts_intra = True

    def plan_phases(self, w: Workload):
        n_gpus = w.cluster.n_gpus
        g = np.arange(n_gpus)
        phases = []
        for k, sizes in enumerate(spreadout_stages(w), start=1):
            phases.append(BarrierStage(sizes=sizes, dsts=(g + k) % n_gpus))
        return tuple(phases), 0.0


# -- Hierarchical ----------------------------------------------------------

@register_scheduler
class HierarchicalScheduler(Scheduler):
    """MSCCL-style rail-aligned hierarchical A2A.

    Matches FLASH on balanced workloads (every rail carries the same bytes)
    but cannot rebalance across NICs under skew -- the max-loaded rail
    becomes the straggler.  Intra-server traffic is not scheduled (rides
    the fabric for free in this model), so ``accounts_intra`` is False.
    """

    name = "hierarchical"
    accounts_intra = False

    def plan_phases(self, w: Workload):
        c = w.cluster
        send, recv, gather = hierarchical_nic_loads(w)
        phases = (
            LoadBalancePhase(moved_per_gpu=gather, charge_alpha=False),
            RailStage(send=send, recv=recv, n_rounds=c.n_servers - 1),
            # Scatter at the receiver pipelines with inter arrivals;
            # charge tail only.
            RedistributePhase(
                bytes_per_gpu=float(recv.max(initial=0.0)) / max(c.m_gpus, 1),
                charge_alpha=False),
        )
        return phases, float(gather.sum())


# -- Optimal (Theorem 1) ---------------------------------------------------

@register_scheduler
class OptimalScheduler(Scheduler):
    """Theorem 1 lower bound: max line sum of the server matrix over the
    aggregate per-server NIC bandwidth.  Not executable on hardware; used
    as the 'optimal' line in every figure."""

    name = "optimal"
    accounts_intra = False

    def plan_phases(self, w: Workload):
        t_server = w.server_matrix()
        # Per-server max(row, col) line sums let the executor bound each
        # server against its own aggregate NIC capacity (heterogeneous NICs).
        line = np.maximum(t_server.sum(axis=1), t_server.sum(axis=0))
        return (BoundStage(bound_bytes=max_line_sum(t_server),
                           inter_total=float(t_server.sum()),
                           line_sums=tuple(float(x) for x in line)),), 0.0


# -- synthesis helpers (vectorized hot paths) ------------------------------

def spreadout_stages(w: Workload) -> List[np.ndarray]:
    """SpreadOut: stage k (k = 1..N-1) pairs GPU g with GPU (g + k) mod N.

    Returns per-stage (N,) arrays of flow sizes; flow g in stage k goes
    g -> (g + k) mod N.  One vectorized gather builds all N-1 stages.
    """
    n_gpus = w.cluster.n_gpus
    g = np.arange(n_gpus)
    k = np.arange(1, n_gpus)[:, None]
    sizes = w.matrix[g[None, :], (g[None, :] + k) % n_gpus]  # (N-1, N)
    return list(sizes)


def hierarchical_nic_loads(w: Workload):
    """MSCCL-style rail-aligned aggregation: per-NIC send/recv byte loads.

    GPU i of server a aggregates (intra-server gather) all local bytes whose
    destination is GPU i of any remote server, then ships it over NIC i to
    the rail peer.  Returns (send_loads, recv_loads, gather_bytes) each of
    shape (n_servers, m).  Fully vectorized (synthesis-speed hot path).
    """
    c = w.cluster
    n, m = c.n_servers, c.m_gpus
    blk = w.matrix.reshape(n, m, n, m)          # [a, g, b, h]
    ar = np.arange(n)
    per_rail = blk.sum(axis=1)                  # [a, b, i]: over local srcs
    diag_rail = per_rail[ar, ar, :]             # [a, i]: own-server block
    send = per_rail.sum(axis=1) - diag_rail     # inter bytes NIC (a, i) ships
    recv = per_rail.sum(axis=0) - diag_rail     # inter bytes NIC (b, i) takes
    own_abi = np.einsum("aibi->abi", blk)       # blk[a, i, b, i]
    own = own_abi.sum(axis=1) - own_abi[ar, ar, :]  # GPU i's own rail bytes
    gather = send - own                         # arriving from local peers
    return send, recv, gather


def optimal_completion_time(w: Workload) -> float:
    """Theorem 1, link-level: each server's max(row, col) line sum over its
    own aggregate NIC capacity, and the whole exchange over the spine.
    Reduces to ``max_line_sum / (m * b_inter)`` on homogeneous fabrics."""
    t_server = w.server_matrix()
    line = np.maximum(t_server.sum(axis=1), t_server.sum(axis=0))
    return w.topo.theorem1_time(line, float(t_server.sum()))


def synthesis_time(
    n_servers: Optional[int] = None,
    m_gpus: Optional[int] = None,
    seed: int = 0,
    workload: Optional[Workload] = None,
) -> float:
    """Measure FLASH schedule-synthesis wall time for a random workload.

    Used by benchmarks/fig17_overhead.py to reproduce the scheduling-time
    claim (us-scale vs TACCL's minutes-to-hours).  Pass either a cluster
    shape (``n_servers``/``m_gpus``) for a generated workload, or an
    explicit ``workload=``; shape arguments that conflict with an explicit
    workload raise instead of being silently ignored.
    """
    from .traffic import random_workload

    if workload is None:
        if n_servers is None:
            raise ValueError("pass n_servers (and optionally m_gpus) or "
                             "an explicit workload=")
        cluster = ClusterSpec(n_servers=n_servers,
                              m_gpus=8 if m_gpus is None else m_gpus)
        workload = random_workload(cluster, mean_size=1 << 20, seed=seed)
    else:
        c = workload.cluster
        if (n_servers is not None and n_servers != c.n_servers) or \
                (m_gpus is not None and m_gpus != c.m_gpus):
            raise ValueError(
                f"conflicting arguments: workload= runs on "
                f"({c.n_servers} servers, {c.m_gpus} GPUs) but "
                f"n_servers={n_servers}, m_gpus={m_gpus} were also given")
    return FlashScheduler().synthesize(workload).synth_seconds


# -- legacy FlashPlan shim -------------------------------------------------

@dataclasses.dataclass(frozen=True)
class FlashPlan:
    """Legacy view of a FLASH Plan (pre-IR API, kept for back-compat).

    Attributes:
      stages: Birkhoff stages over the *server-level* matrix, ascending size
        (paper 4.3: ascending order lets stage k's redistribute hide under
        stage k+1's inter-server transfer).
      lb_moved_per_gpu: (n_servers, m) bytes each GPU must shed during the
        load-balance phase (max over destinations handled concurrently).
      redistribute_tail: bytes/GPU redistributed after the *last* stage (the
        un-hidden pipeline tail).
      intra_bytes: S_i per server, overlapped with the first inter stage.
      synth_seconds: wall-clock time spent computing this plan.
    """

    cluster: ClusterSpec
    stages: List[Stage]
    lb_moved_per_gpu: np.ndarray
    redistribute_tail: float
    intra_bytes: np.ndarray
    synth_seconds: float

    @property
    def n_stages(self) -> int:
        return len(self.stages)

    @property
    def inter_bytes(self) -> float:
        """Genuine bytes crossing the inter-server network."""
        return float(sum(s.real_bytes for s in self.stages))

    def stage_sizes(self) -> np.ndarray:
        return np.array([s.size for s in self.stages])

    @classmethod
    def from_plan(cls, plan: Plan) -> "FlashPlan":
        if plan.algorithm != "flash":
            raise ValueError(f"not a flash plan: {plan.algorithm!r}")
        stages = []
        for p in plan.phases:
            if isinstance(p, PermutationStage):
                stages.append(Stage(perm=p.perm, size=p.size, sent=p.sent))
            elif isinstance(p, PermutationBlock):
                stages.extend(Stage(perm=s.perm, size=s.size, sent=s.sent)
                              for s in p.iter_stages())
        lb = next(p.moved_per_gpu for p in plan.phases
                  if isinstance(p, LoadBalancePhase))
        tail = next((p.bytes_per_gpu for p in plan.phases
                     if isinstance(p, RedistributePhase)), 0.0)
        s_intra = next(p.per_server for p in plan.phases
                       if isinstance(p, IntraOverlapPhase))
        return cls(cluster=plan.cluster, stages=stages, lb_moved_per_gpu=lb,
                   redistribute_tail=tail, intra_bytes=s_intra,
                   synth_seconds=plan.synth_seconds)


def flash_schedule(w: Workload) -> FlashPlan:
    """Back-compat shim: synthesize FLASH and return the legacy view."""
    return FlashPlan.from_plan(FlashScheduler().synthesize(w))
