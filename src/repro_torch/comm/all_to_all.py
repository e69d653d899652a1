"""All-to-All schedules on a mesh, and the one registry that selects them.

Counterpart of ``src/repro/comm/all_to_all.py``.  Every impl takes a stacked
``x [R, n_shards, ...]`` (rank-major, see ``launch/mesh.py``; ``R`` is the
mesh's ``local_size``: every rank on a ``LocalMesh``, one on a
``ProcessMesh``) and returns, per rank, exactly

    out[src_shard] = chunk that shard ``src_shard`` addressed to this rank

with the combined shard index ordered slow-axis-major, so all impls are
bit-identical to ``direct_all_to_all`` and interchangeable by name.

Registered: ``direct`` (one flat all-to-all), ``flash`` (the FAST two-tier
schedule: an intra-pod all-to-all aligns each block with its rail, then one
``ppermute`` per Birkhoff rotation over the slow axis), ``hierarchical`` (the
same rotations with the intra-pod redistribution after the slow hop) and
``plan`` (``comm/plan_exec.py``).  ``rotation_all_to_all`` is the schedule for
EP over the slow axis alone; ``fast_only_all_to_all`` the degenerate case with
no slow traffic.  On a ``LocalMesh`` every ``ppermute`` and all-to-all is a
device-side copy, so the schedules differ only in the order of the copies;
on a ``ProcessMesh`` they are the process groups' collectives.
"""

from __future__ import annotations

from functools import partial
from typing import Callable, Optional, Sequence, Tuple, Union

import numpy as np
import torch

from .. import trace
from ..launch.mesh import LocalMesh, ProcessMesh, all_to_all, ppermute

__all__ = [
    "ALL_TO_ALL_IMPLS",
    "register_all_to_all_impl",
    "available_all_to_all_impls",
    "all_to_all_by_name",
    "direct_all_to_all",
    "flash_all_to_all",
    "hierarchical_all_to_all",
    "fast_only_all_to_all",
    "rotation_all_to_all",
    "intra_all_to_all",
    "resolve_all_to_all",
]

AxisNames = Union[str, Tuple[str, ...]]
Mesh = Union[LocalMesh, ProcessMesh]

# name -> fn(x, slow_axis, fast_axes, *, mesh)
ALL_TO_ALL_IMPLS: dict = {}


def register_all_to_all_impl(name: str):
    """Decorator: register a two-tier all_to_all implementation."""

    def deco(fn):
        ALL_TO_ALL_IMPLS[name] = fn
        return fn

    return deco


def _as_tuple(axes: AxisNames) -> Tuple[str, ...]:
    return (axes,) if isinstance(axes, str) else tuple(axes)


def _ensure_extra_impls() -> None:
    """Import-on-demand registration of ``plan`` (plan_exec imports this
    module, so it cannot be imported at module scope without a cycle)."""
    if "plan" not in ALL_TO_ALL_IMPLS:
        from . import plan_exec  # noqa: F401  (registers impl="plan")


def available_all_to_all_impls() -> list:
    _ensure_extra_impls()
    return sorted(ALL_TO_ALL_IMPLS)


def all_to_all_by_name(name: str):
    _ensure_extra_impls()
    if name in ALL_TO_ALL_IMPLS:
        return ALL_TO_ALL_IMPLS[name]
    raise ValueError(f"unknown all_to_all impl {name!r}; pick from "
                     f"{sorted(ALL_TO_ALL_IMPLS)}")


@register_all_to_all_impl("direct")
def direct_all_to_all(x: torch.Tensor, slow_axis: str, fast_axes: AxisNames,
                      *, mesh: Mesh) -> torch.Tensor:
    """One flat all-to-all over the combined (slow, fast...) axes."""
    axes = (slow_axis, *_as_tuple(fast_axes))
    return all_to_all(mesh, x, axes)


def intra_all_to_all(x: torch.Tensor, fast_axes: AxisNames, *,
                     mesh: Mesh) -> torch.Tensor:
    """All-to-all restricted to the fast (intra-pod) axes, in the span
    ``a2a.intra``."""
    with trace.span("a2a.intra"):
        return all_to_all(mesh, x, _as_tuple(fast_axes))


def _ranks(mesh: Mesh, device) -> torch.Tensor:
    return mesh.cached_index(("ranks",), device,
                             lambda: np.arange(mesh.local_size))


def _shifted(mesh: Mesh, axis: str, shift: int, device) -> torch.Tensor:
    """``[local_size]``: each held rank's coordinate along ``axis`` plus
    ``shift``, modulo the axis size (the reference's ``lax.rem(my + shift,
    p)``)."""
    a = mesh.axis_names.index(axis)
    return mesh.cached_index(
        ("shifted", axis, shift), device,
        lambda: (mesh.local_coords()[:, a] + shift) % mesh.shape[a])


def _rotations(x: torch.Tensor, axis: str, mesh: Mesh,
               before=None, after=None) -> torch.Tensor:
    """The balanced Birkhoff rotation schedule over ``axis`` on stacked
    ``x [R, p, ...]``: stage ``shift`` sends each rank's block for
    coordinate ``my + shift`` to that peer with one ``ppermute`` (stage 0
    stays local) and stores what arrives at the sender's coordinate
    ``my - shift``.  ``before`` / ``after`` transform each block before and
    after its hop (the intra-pod exchange of ``flash`` / ``hierarchical``).
    """
    p = mesh.axis_size(axis)
    if x.shape[1] != p:
        raise ValueError(f"leading dim {x.shape[1]} != axis size {p}")
    ranks = _ranks(mesh, x.device)
    out = torch.zeros_like(x)
    for shift in range(p):
        blk = x[ranks, _shifted(mesh, axis, shift, x.device)]
        if before is not None:
            blk = before(blk)
        if shift:
            blk = ppermute(mesh, blk, axis,
                           [(q, (q + shift) % p) for q in range(p)])
        if after is not None:
            blk = after(blk)
        out[ranks, _shifted(mesh, axis, -shift, x.device)] = blk
    return out


def _two_tier(x: torch.Tensor, slow_axis: str, fast_axes: AxisNames,
              mesh: Mesh, intra_first: bool) -> torch.Tensor:
    fast = _as_tuple(fast_axes)
    p = mesh.axis_size(slow_axis)
    i = mesh.axis_size(fast)
    r, n, rest = x.shape[0], x.shape[1], tuple(x.shape[2:])
    if n != p * i:
        raise ValueError(f"leading dim {n} != slow*fast = {p}*{i}")
    intra = partial(intra_all_to_all, fast_axes=fast, mesh=mesh)
    out = _rotations(x.reshape(r, p, i, *rest), slow_axis, mesh,
                     before=intra if intra_first else None,
                     after=None if intra_first else intra)
    return out.reshape(x.shape)


@register_all_to_all_impl("flash")
def flash_all_to_all(x: torch.Tensor, slow_axis: str, fast_axes: AxisNames,
                     *, mesh: Mesh) -> torch.Tensor:
    """FLASH two-tier All-to-All: per rotation, load balance first (the
    intra-pod all-to-all hands local rank ``i`` every block bound for fast
    index ``i`` of the destination pod), then one contiguous transfer to the
    rail peer over the slow axis; the redistribution is then a no-op."""
    return _two_tier(x, slow_axis, fast_axes, mesh, intra_first=True)


@register_all_to_all_impl("hierarchical")
def hierarchical_all_to_all(x: torch.Tensor, slow_axis: str,
                            fast_axes: AxisNames, *,
                            mesh: Mesh) -> torch.Tensor:
    """MSCCL-style baseline: the same rotations, each rank shipping its own
    block over the slow axis first and the receiving pod redistributing it
    over the fast axes after."""
    return _two_tier(x, slow_axis, fast_axes, mesh, intra_first=False)


def fast_only_all_to_all(x: torch.Tensor, slow_axis: str,
                         fast_axes: AxisNames, *,
                         mesh: Mesh) -> torch.Tensor:
    """Degenerate case: EP axis entirely inside one pod (no slow traffic)."""
    del slow_axis
    return intra_all_to_all(x, fast_axes, mesh=mesh)


def rotation_all_to_all(x: torch.Tensor, axis: str, *,
                        mesh: Mesh) -> torch.Tensor:
    """All-to-all over one axis as ``p - 1`` ppermute rotations: the FLASH
    form of a slow-axis-only exchange (mixtral: EP over ``pod``)."""
    return _rotations(x, axis, mesh)


def resolve_all_to_all(
    dist=None,
    *,
    mesh: Optional[Mesh] = None,
    slow_axis: Optional[str] = None,
    ep_axes: Optional[Sequence[str]] = None,
    impl: str = "flash",
    topology=None,
    plan=None,
    use_kernel: bool = True,
) -> Optional[Callable[[torch.Tensor], torch.Tensor]]:
    """Select the A2A schedule for an EP-axis layout, with the reference's
    rules (``src/repro/comm/all_to_all.py::resolve_all_to_all``).

    Pass a ``DistContext`` (the exchange runs on its mesh of the DP axes)
    or the keyword form with ``mesh``.  EP over the slow axis and fast axes
    runs the registered impl ``impl``; EP over the slow axis alone runs the
    rotation schedule (the plan's stages under ``impl="plan"``); EP over
    fast axes alone runs the intra-pod all-to-all.  ``impl="auto"`` picks
    ``plan`` when a plan is supplied, else ``flash`` on a heterogeneous
    fabric and ``direct`` otherwise.  ``use_kernel`` reaches ``plan``'s pack
    and unpack.  Returns a unary ``buf -> buf`` callable on stacked buffers,
    or None when there are no EP axes.
    """
    if dist is not None:
        mesh = dist.mesh.sub(dist.dp_axes)
        slow_axis = dist.slow_axis
        ep_axes = dist.ep_axes
        impl = dist.a2a_impl
        topology = getattr(dist, "topology", topology)
        plan = getattr(dist, "plan", plan)
        use_kernel = getattr(dist, "use_kernel", use_kernel)
    if impl == "auto":
        if plan is not None:
            impl = "plan"
        else:
            hetero = topology is not None and not topology.is_homogeneous
            impl = "flash" if hetero else "direct"
    # Fail fast on unknown impl names on every path, including the
    # rotation and intra-pod ones that do not dispatch through the registry.
    two_tier = all_to_all_by_name(impl)
    if impl == "plan":
        if plan is None:
            raise ValueError(
                'impl="plan" needs a synthesized plan/schedule: pass '
                "plan= (or set DistContext.plan)")
        two_tier = partial(two_tier, plan=plan, use_kernel=use_kernel)
    ep = tuple(ep_axes or ())
    if not ep:
        return None
    if mesh is None:
        raise ValueError("resolve_all_to_all needs the mesh")
    if slow_axis in ep and len(ep) > 1:
        fast = tuple(a for a in ep if a != slow_axis)
        return partial(two_tier, slow_axis=slow_axis, fast_axes=fast,
                       mesh=mesh)
    if ep == (slow_axis,):
        if impl == "plan":
            # slow-axis-only EP still follows the plan's stage order
            return partial(two_tier, slow_axis=slow_axis, fast_axes=(),
                           mesh=mesh)
        return partial(rotation_all_to_all, axis=slow_axis, mesh=mesh)
    return partial(intra_all_to_all, fast_axes=ep, mesh=mesh)
