"""Plan-driven All-to-All on a mesh: lower a synthesized Plan and run it as
pack -> intra-pod all-to-all -> one ppermute per stage -> unpack.

Counterpart of ``src/repro/comm/plan_exec.py``.  ``lower_plan`` is the same
pure-Python lowering (a ``Plan``'s Birkhoff permutation stages, first
occurrence of each pod pair, then rotation stages for pairs the plan never
names), memoized on the plan object under its own attribute so a plan
lowered by both packages never hands one package the other's type.

``plan_all_to_all`` runs every rank the mesh holds here at once (all of
them on a ``LocalMesh``, this process's own on a ``ProcessMesh``): the
per-rank ``dst_idx`` / ``src_idx`` rows are built on the host from the
static stage tables and offset into global block indices over the held
ranks' rows, so ONE ``a2a_pack`` launch packs them all and ONE
``a2a_unpack`` launch scatters each into its own ``p + 1`` output blocks
(the last one a per-rank trash block for idle stages, sliced off at the
end; one per process on a ``ProcessMesh``).  The result is bit-identical
to ``direct_all_to_all``.
"""

from __future__ import annotations

import dataclasses
from typing import Optional, Tuple

import torch

from ..kernels.a2a_pack.a2a_pack import a2a_pack, a2a_unpack
from ..kernels.a2a_pack.ref import a2a_pack_ref, a2a_unpack_ref
from ..launch.mesh import all_to_all, ppermute
from .all_to_all import _as_tuple, register_all_to_all_impl

__all__ = ["DeviceSchedule", "lower_plan", "is_lowered", "plan_all_to_all"]

_MEMO_ATTR = "_torch_device_sched"
_MEMO_CAP = 8  # serving loops see 1-2 pod counts per plan (Plan.compile's cap)


@dataclasses.dataclass(frozen=True)
class DeviceSchedule:
    """A plan lowered to static ppermute stages over ``n_pods`` pods.

    ``pairs[k]`` is stage ``k``'s ppermute permutation -- the live
    ``(src, dst)`` pod pairs, incast-free (a partial permutation; pods can
    idle).  ``dst_of[k][q]`` / ``src_of[k][q]`` are pod ``q``'s send
    target / receive source in stage ``k`` (-1 = idle), the tables the
    SPMD program gathers its own role from at trace time.  Stages
    ``< n_plan_stages`` came from the plan (first occurrence of each
    pair, plan order); the remaining ``n_fallback_stages`` are the
    coverage-completing rotations for pairs the plan never scheduled.
    """

    n_pods: int
    pairs: Tuple[Tuple[Tuple[int, int], ...], ...]
    dst_of: Tuple[Tuple[int, ...], ...]
    src_of: Tuple[Tuple[int, ...], ...]
    n_plan_stages: int
    n_fallback_stages: int
    plan_fingerprint: Optional[str]
    algorithm: str

    @property
    def n_stages(self) -> int:
        return len(self.pairs)


def _iter_perm_stages(plan):
    """Every inter-server permutation of ``plan`` in execution order.

    Delegates to ``Plan.iter_perm_stages`` (the core-side device-lowering
    view); the structural fallback keeps duck-typed plan stand-ins from
    tests working.
    """
    view = getattr(plan, "iter_perm_stages", None)
    if view is not None:
        yield from view()
        return
    from ..core.plan import PermutationBlock, PermutationStage

    for phase in plan.phases:
        if isinstance(phase, PermutationStage):
            yield phase.perm
        elif isinstance(phase, PermutationBlock):
            for row in phase.perms:
                yield tuple(int(j) for j in row)


def _as_plan(plan_or_schedule):
    """Accept a Plan or anything carrying one (ExecutableSchedule)."""
    inner = getattr(plan_or_schedule, "plan", None)
    return plan_or_schedule if inner is None else inner


def _stage_tables(n: int, stage_pairs):
    dst = [-1] * n
    src = [-1] * n
    for s, d in stage_pairs:
        dst[s] = d
        src[d] = s
    return tuple(dst), tuple(src)


def lower_plan(plan_or_schedule, n_pods: Optional[int] = None
               ) -> DeviceSchedule:
    """Lower a ``Plan`` / ``ExecutableSchedule`` to a ``DeviceSchedule``.

    Pure function of (plan stages, n_pods) -- deterministic per plan
    fingerprint -- and memoized on the plan object keyed by ``n_pods``,
    alongside the ``Plan.compile`` slot, so a ``PlanCache`` hit (or a
    daemon answer) carries the lowering with it.
    """
    plan = _as_plan(plan_or_schedule)
    n = int(plan.cluster.n_servers)
    p = n if n_pods is None else int(n_pods)
    if p != n:
        raise ValueError(
            f"mesh slow axis has {p} pods but the plan was synthesized "
            f"for {n} servers; re-plan on a matching ClusterSpec")
    memo = plan.__dict__.get(_MEMO_ATTR)
    if memo is None:
        memo = {}
        object.__setattr__(plan, _MEMO_ATTR, memo)
    sched = memo.get(p)
    if sched is not None:
        return sched

    delivered = set()
    stages = []
    for perm in _iter_perm_stages(plan):
        fresh = []
        for s, d in enumerate(perm[:p]):
            d = int(d)
            if d < 0 or d == s or (s, d) in delivered:
                continue  # idle slot / self traffic / already shipped
            delivered.add((s, d))
            fresh.append((s, d))
        if fresh:
            stages.append(tuple(fresh))
    n_plan_stages = len(stages)
    # Coverage completion: pairs the plan never scheduled (zero traffic in
    # the matrix) still owe their capacity-padding block.  Each shift's
    # residue is itself a partial permutation, so incast-freedom holds.
    for shift in range(1, p):
        missing = tuple((q, (q + shift) % p) for q in range(p)
                        if (q, (q + shift) % p) not in delivered)
        if missing:
            stages.append(missing)
    sched = DeviceSchedule(
        n_pods=p,
        pairs=tuple(stages),
        dst_of=tuple(_stage_tables(p, st)[0] for st in stages),
        src_of=tuple(_stage_tables(p, st)[1] for st in stages),
        n_plan_stages=n_plan_stages,
        n_fallback_stages=len(stages) - n_plan_stages,
        plan_fingerprint=plan.fingerprint,
        algorithm=plan.algorithm,
    )
    if len(memo) >= _MEMO_CAP:
        memo.clear()
    memo[p] = sched
    return sched


def is_lowered(plan_or_schedule, n_pods: Optional[int] = None) -> bool:
    """True when ``lower_plan`` for this pod count would be a memo hit."""
    plan = _as_plan(plan_or_schedule)
    p = int(plan.cluster.n_servers) if n_pods is None else int(n_pods)
    return p in plan.__dict__.get(_MEMO_ATTR, {})


def _global_rows(mesh, sched: DeviceSchedule,
                 pods: Tuple[int, ...], blocks_per_rank: int, table: str,
                 idle: Optional[int], device) -> torch.Tensor:
    """Every held rank's pack (``table="dst_of"``) or unpack (``"src_of"``)
    index row -- its own pod first, then its role in each stage, ``idle``
    (or its own pod when None) where it has none -- offset by ``rank *
    blocks_per_rank`` (``rank`` counting the held ranks) into global block
    indices, flattened to int32.  Built
    once per schedule and mesh, on the host from the static stage tables."""
    def build():
        tab = getattr(sched, table)
        rows = []
        for rank, q in enumerate(pods):
            row = [q] + [tab[k][q] for k in range(sched.n_stages)]
            fill = q if idle is None else idle
            rows.extend(rank * blocks_per_rank + (v if v >= 0 else fill)
                        for v in row)
        return rows

    return mesh.cached_index(("plan_rows", sched, pods, blocks_per_rank,
                              table, idle), device, build, dtype=torch.int32)


@register_all_to_all_impl("plan")
def plan_all_to_all(x: torch.Tensor, slow_axis: str, fast_axes, *,
                    mesh, plan=None, schedule=None,
                    use_kernel: bool = True) -> torch.Tensor:
    """Execute a lowered plan as the two-tier All-to-All on stacked
    ``x [R, n_shards, ...]``.

    Same contract as every registry impl, bit-identical to
    ``direct_all_to_all``; the slow-axis stage order comes from the
    synthesized plan.  ``use_kernel=False`` runs the plain PyTorch pack and
    unpack instead of the CUDA kernels.
    """
    src = schedule if schedule is not None else plan
    if src is None:
        raise ValueError(
            'impl="plan" needs a synthesized plan: pass plan=/schedule= '
            "through resolve_all_to_all (or DistContext.plan)")
    fast = _as_tuple(fast_axes) if fast_axes else ()
    p = mesh.axis_size(slow_axis)
    i = mesh.axis_size(fast) if fast else 1
    r = mesh.local_size
    if x.shape[0] != r:
        raise ValueError(f"leading dim {x.shape[0]} != {r} ranks")
    n, rest = x.shape[1], tuple(x.shape[2:])
    if n != p * i:
        raise ValueError(f"leading dim {n} != slow*fast = {p}*{i}")
    sched = lower_plan(src, n_pods=p)
    s = sched.n_stages
    pods = tuple(mesh.local_coords()[
        :, mesh.axis_names.index(slow_axis)].tolist())
    pack = a2a_pack if use_kernel else a2a_pack_ref
    unpack = a2a_unpack if use_kernel else a2a_unpack_ref

    # Block view: rank r's pod-q block is the contiguous run of rows
    # [(r*p + q)*B, (r*p + q + 1)*B) of all ranks' rows.
    inner = 1
    for dim in rest[:-1]:
        inner *= dim
    d = rest[-1] if rest else 1
    block = i * inner
    x2 = x.contiguous().reshape(r * p * block, d)

    # Slot packing: every rank's send block for every stage in one buffer
    # (slot 0 = the intra-pod block; idle stages repack the local block,
    # which is never shipped).
    dst_idx = _global_rows(mesh, sched, pods, p, "dst_of", None, x.device)
    send = pack(x2, dst_idx, block_rows=block)
    buf = send.reshape(r, s + 1, i, *rest)

    # Load balance: ONE intra-pod all-to-all rail-aligns every stage block.
    if fast:
        buf = all_to_all(mesh, buf, fast, axis=1)

    # Merged transfers: one ppermute per lowered stage over the slow axis.
    recv = [buf[:, 0]]
    for k in range(s):
        recv.append(ppermute(mesh, buf[:, k + 1], slow_axis,
                             sched.pairs[k]))
    stack2 = torch.stack(recv, dim=1).reshape(r * (s + 1) * block, d)

    # Slot unpacking: each received stage block goes to its source pod's
    # slot of its own rank; idle stages land in the rank's trash block p.
    src_idx = _global_rows(mesh, sched, pods, p + 1, "src_of", p,
                           x.device)
    out2 = unpack(stack2, src_idx, n_out_blocks=r * (p + 1),
                  block_rows=block)
    out = out2[: r * (p + 1) * block].reshape(r, p + 1, block, d)[:, :p]
    return out.reshape(r, n, *rest)
