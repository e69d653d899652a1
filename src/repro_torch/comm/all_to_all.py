"""All-to-All schedules on a local mesh, and the one registry that selects
them.

Counterpart of ``src/repro/comm/all_to_all.py``.  Every impl takes a stacked
``x [R, n_shards, ...]`` (rank-major, see ``launch/mesh.py``) and returns,
per rank, exactly

    out[src_shard] = chunk that shard ``src_shard`` addressed to this rank

with the combined shard index ordered slow-axis-major, so all impls are
bit-identical to ``direct_all_to_all`` and interchangeable by name.

Ported: ``direct``, ``intra`` (the fast-axes exchange) and ``plan``
(``comm/plan_exec.py``).  ``flash``, ``hierarchical`` and ``rotation`` are
not ported yet; asking for one raises ``NotImplementedError`` and never
substitutes another impl.
"""

from __future__ import annotations

from functools import partial
from typing import Callable, Optional, Sequence, Tuple, Union

import torch

from ..launch.mesh import LocalMesh, all_to_all

__all__ = [
    "ALL_TO_ALL_IMPLS",
    "NOT_PORTED",
    "register_all_to_all_impl",
    "available_all_to_all_impls",
    "all_to_all_by_name",
    "direct_all_to_all",
    "intra_all_to_all",
    "resolve_all_to_all",
]

AxisNames = Union[str, Tuple[str, ...]]

# name -> fn(x, slow_axis, fast_axes, *, mesh)
ALL_TO_ALL_IMPLS: dict = {}

# Registry names of the reference that have no port yet, with the
# ROADMAP.md item that ports them.
_TODO = "ROADMAP.md Queue 1, item 1 (flash, hierarchical, rotation impls)"
NOT_PORTED = {"flash": _TODO, "hierarchical": _TODO, "rotation": _TODO}


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
    if name in NOT_PORTED:
        raise NotImplementedError(
            f"all_to_all impl {name!r} is not ported to PyTorch yet: "
            f"{NOT_PORTED[name]}")
    raise ValueError(f"unknown all_to_all impl {name!r}; pick from "
                     f"{sorted(ALL_TO_ALL_IMPLS)}")


@register_all_to_all_impl("direct")
def direct_all_to_all(x: torch.Tensor, slow_axis: str, fast_axes: AxisNames,
                      *, mesh: LocalMesh) -> torch.Tensor:
    """One flat all-to-all over the combined (slow, fast...) axes."""
    axes = (slow_axis, *_as_tuple(fast_axes))
    return all_to_all(mesh, x, axes)


def intra_all_to_all(x: torch.Tensor, fast_axes: AxisNames, *,
                     mesh: LocalMesh) -> torch.Tensor:
    """All-to-all restricted to the fast (intra-pod) axes."""
    return all_to_all(mesh, x, _as_tuple(fast_axes))


def resolve_all_to_all(
    dist=None,
    *,
    mesh: Optional[LocalMesh] = None,
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
    or the keyword form with ``mesh``.  ``impl="auto"`` picks ``plan`` when a
    plan is supplied, else ``flash`` on a heterogeneous fabric and
    ``direct`` otherwise.  ``use_kernel`` reaches ``plan``'s pack and
    unpack.  Returns a unary ``buf -> buf`` callable on stacked buffers, or
    None when there are no EP axes.
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
    # Fail fast on unknown or unported impl names on every path.
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
        raise ValueError("resolve_all_to_all needs the local mesh")
    if slow_axis in ep and len(ep) > 1:
        fast = tuple(a for a in ep if a != slow_axis)
        return partial(two_tier, slow_axis=slow_axis, fast_axes=fast,
                       mesh=mesh)
    if ep == (slow_axis,):
        if impl == "plan":
            return partial(two_tier, slow_axis=slow_axis, fast_axes=(),
                           mesh=mesh)
        all_to_all_by_name("rotation")  # raises NotImplementedError
    return partial(intra_all_to_all, fast_axes=ep, mesh=mesh)
