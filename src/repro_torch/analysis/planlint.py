"""Workload-independent plan verifier.

``Plan.validate(w)`` proves byte conservation *against a workload* -- but
a serialized plan corpus or a live ``PlanCache`` has no workloads
attached, only plans.  This pass checks every invariant a plan must
satisfy on its own:

  * **PLAN-STRUCT** -- everything ``Plan.validate_structure`` proves:
    permutation stages are incast-free and self-traffic-free, payloads
    fit their per-sender slots, blocks are shape-consistent, and
    capacity-aware plans are slot-vs-rail feasible on their own fabric.
  * **PLAN-SHAPE** -- the plan's topology agrees with its cluster view
    (server/GPU counts) and every permutation is n_servers wide.
  * **PLAN-ORDER** -- consecutive cold ``PermutationStage`` phases run in
    ascending duration order (the Theorem-2 pipelining contract:
    synthesis sorts stages so each stage's redistribute hides under the
    *next* stage's transfer).  ``PermutationBlock`` phases are exempt --
    incremental repair deliberately emits stages in stored order.
  * **PLAN-FPRINT** -- serialization round-trip stability: rebuilding the
    plan from ``to_dict()`` must preserve the topology fingerprint (a
    drifting fingerprint would turn every cache hit cold after a
    save/load cycle).
  * **CACHE-FAMILY** (audit mode) -- each cached family head actually
    belongs to the family key it is indexed under, so warm-start lookups
    can never seed a repair from a different fabric's plan.

``audit_cache`` runs the whole battery over ``PlanCache.family_heads()``;
``PlanServer.audit()`` exposes it on the live daemon.
"""

from __future__ import annotations

import json
import os
from typing import Dict, List, Optional, Sequence

import numpy as np

from ..core.birkhoff import stage_duration
from ..core.plan import (
    PermutationStage,
    Plan,
    PlanValidationError,
    plan_family_key,
)

__all__ = ["check_plan", "check_file", "check_paths", "audit_cache"]

# Slack factor for the ascending-duration check; synthesis sorts stages
# by exact duration, so anything beyond float noise is a real inversion.
_ORDER_RTOL = 1e-9


def _issue(code: str, message: str, source: str) -> Dict:
    return {"code": code, "message": message, "source": source}


def check_plan(plan: Plan, source: str = "<plan>") -> List[Dict]:
    """Every workload-independent defect of one plan (empty = clean)."""
    issues: List[Dict] = []

    try:
        plan.validate_structure()
    except PlanValidationError as e:
        issues.append(_issue("PLAN-STRUCT", str(e), source))

    topo = plan.topo
    n = plan.cluster.n_servers
    if (topo.n_servers, topo.m_gpus) != (n, plan.cluster.m_gpus):
        issues.append(_issue(
            "PLAN-SHAPE",
            f"topology is {topo.n_servers}x{topo.m_gpus} but the cluster "
            f"view says {n}x{plan.cluster.m_gpus}", source))
    for k, p in enumerate(plan.phases):
        if isinstance(p, PermutationStage) and len(p.perm) != n:
            issues.append(_issue(
                "PLAN-SHAPE",
                f"stage {k} permutation is {len(p.perm)} wide on an "
                f"{n}-server cluster", source))

    issues.extend(_check_stage_order(plan, source))

    try:
        rebuilt = Plan.from_dict(plan.to_dict())
    except PlanValidationError as e:
        issues.append(_issue(
            "PLAN-FPRINT", f"plan does not round-trip: {e}", source))
    else:
        if rebuilt.topo.fingerprint() != topo.fingerprint():
            issues.append(_issue(
                "PLAN-FPRINT",
                "topology fingerprint drifts across a to_dict/from_dict "
                "round trip; cached plans would go cold after save/load",
                source))
    return issues


def _check_stage_order(plan: Plan, source: str) -> List[Dict]:
    """Ascending order over runs of consecutive cold stages.

    Synthesis sorts by the quantity its decomposition actually ranks:
    capacity-aware plans by per-stage *duration* on their own fabric,
    capacity-blind plans by slot *size* (duration's proxy under the
    uniform-capacity assumption they were built with -- on a degraded
    fabric a blind plan's durations legitimately interleave).
    """
    caps = plan.topo.pair_capacity() if plan.capacity_aware else None
    unit = "s" if plan.capacity_aware else " bytes"
    issues: List[Dict] = []
    prev: Optional[float] = None
    prev_k = -1
    for k, p in enumerate(plan.phases):
        if not isinstance(p, PermutationStage):
            prev = None
            continue
        key = (stage_duration(p, caps) if caps is not None
               else float(p.size))
        if prev is not None and np.isfinite(prev) and np.isfinite(key) \
                and key < prev * (1 - _ORDER_RTOL):
            issues.append(_issue(
                "PLAN-ORDER",
                f"stage {k} ({key:.6g}{unit}) runs before-sorted stage "
                f"{prev_k} ({prev:.6g}{unit}): cold permutation stages "
                "must ascend so redistributes pipeline (Theorem 2)",
                source))
        prev, prev_k = key, k
    return issues


def check_file(path: str) -> List[Dict]:
    """Verify one JSON file holding a plan dict or a list of them."""
    try:
        with open(path, "r") as f:
            data = json.load(f)
    except (OSError, json.JSONDecodeError) as e:
        return [_issue("PLAN-IO", f"unreadable plan file: {e}", path)]
    plans = data if isinstance(data, list) else [data]
    issues: List[Dict] = []
    for i, d in enumerate(plans):
        src = f"{path}[{i}]" if isinstance(data, list) else path
        try:
            plan = Plan.from_dict(d)
        except (PlanValidationError, KeyError, TypeError, ValueError) as e:
            issues.append(_issue(
                "PLAN-IO", f"undeserializable plan: {e}", src))
            continue
        issues.extend(check_plan(plan, src))
    return issues


def check_paths(paths: Sequence[str]) -> Dict:
    """Verify a corpus of plan JSON files; directories are walked for
    ``*.json``.  Returns ``{"plans": n, "files": n, "issues": [...]}``."""
    files: List[str] = []
    for p in paths:
        if os.path.isdir(p):
            for name in sorted(os.listdir(p)):
                if name.endswith(".json"):
                    files.append(os.path.join(p, name))
        else:
            files.append(p)
    issues: List[Dict] = []
    plans = 0
    for path in files:
        try:
            with open(path, "r") as f:
                data = json.load(f)
            plans += len(data) if isinstance(data, list) else 1
        except (OSError, json.JSONDecodeError):
            plans += 1  # counted; check_file reports the IO issue
        issues.extend(check_file(path))
    return {"files": len(files), "plans": plans, "issues": issues,
            "clean": not issues}


def audit_cache(cache) -> Dict:
    """Verify every family head of a live ``PlanCache``.

    Beyond the per-plan battery, proves the family index itself: the plan
    stored under family key F must re-derive F from its own cluster,
    topology and algorithm -- a mismatch means warm-start would seed
    repairs from the wrong fabric's plan.
    """
    heads = cache.family_heads()
    issues: List[Dict] = []
    for family, plan in heads:
        source = f"cache:{family[:12]}"
        issues.extend(check_plan(plan, source))
        derived = plan_family_key(plan)
        if derived != family:
            issues.append(_issue(
                "CACHE-FAMILY",
                f"plan indexed under family {family[:12]}... but derives "
                f"{derived[:12]}... from its own cluster/topology/"
                "algorithm", source))
    return {"plans": len(heads), "issues": issues, "clean": not issues}
