"""The meshes of the port: every rank of a ``("pod", "data", "model")`` mesh
stacked on one device (``LocalMesh``), or one OS process per rank
(``ProcessMesh``).

The JAX package runs its expert-parallel program under ``shard_map`` on a
mesh of devices.  On a ``LocalMesh`` one device holds all ranks: a per-rank
tensor of shape ``[...]`` becomes a stacked tensor ``[R, ...]`` whose
leading index is the rank, ranks in row-major order over the mesh axes (slow
axis major), the same order as the JAX mesh's devices.  On a ``ProcessMesh``
(``launch/procs.py`` starts it) each process holds its own rank, as a stack
of one, ``[1, ...]``, so the code above the mesh runs unchanged on either.
The collectives below compute what ``lax.all_to_all``, ``lax.ppermute``,
``lax.axis_index`` and ``lax.pmean`` compute per rank: device-side copies on
a ``LocalMesh``, ``torch.distributed`` calls on a ``ProcessMesh``'s process
groups.  Both forms carry gradients, with ``lax``'s transpose rules: on a
``LocalMesh`` autograd differentiates the index copies, on a ``ProcessMesh``
each collective is an ``autograd.Function`` whose backward runs the
transposed collective (the same tiled ``all_to_all``; ``ppermute`` with every
pair reversed; ``pmean`` of the cotangents over the group).

``size`` is the number of ranks of the mesh and ``coords()`` their
coordinates; ``local_size``, ``local_shape`` and ``local_coords()`` are those
of the ranks this process holds (all of them on a ``LocalMesh``, its own on a
``ProcessMesh``).

Each process collective reports itself to ``launch/roofline.count()`` (the
op, the group's size, its operand's bytes and the tier, ``pod`` among the
axes being the slow one) before it moves anything.  ``dry_mesh`` is one
rank's ``ProcessMesh`` with no world: on ``meta`` tensors, its collectives
report and return empty results of the right shapes, so a rank's program
runs at any width with no memory and no other process (``launch/dryrun.py``).
"""

from __future__ import annotations

import dataclasses
from typing import Callable, Optional, Sequence, Tuple, Union

import numpy as np
import torch
import torch.distributed as torch_dist

from . import roofline

__all__ = ["LocalMesh", "ProcessMesh", "make_mesh", "make_production_mesh",
           "parse_mesh",
           "dry_mesh", "resolve_device", "dp_axes", "slow_axis", "all_to_all",
           "ppermute", "axis_index", "pmean", "all_gather", "member_sum",
           "all_ranks"]

AxisNames = Union[str, Tuple[str, ...]]


def resolve_device(device: Union[str, torch.device]) -> torch.device:
    """``torch.device(device)``; raises for a CUDA device when none is
    present, so an entry point never drops to the CPU on its own."""
    dev = torch.device(device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            f"device {str(dev)!r} requested but CUDA is not available; "
            "pass device='cpu' to run on the CPU")
    return dev


def _as_tuple(axes: AxisNames) -> Tuple[str, ...]:
    return (axes,) if isinstance(axes, str) else tuple(axes)


@dataclasses.dataclass(frozen=True)
class LocalMesh:
    """Named axes over ``R = prod(shape)`` ranks stacked on ``device``."""

    shape: Tuple[int, ...]
    axis_names: Tuple[str, ...]
    device: torch.device
    # Index tensors of the collectives (and sub-meshes), built once per
    # pattern: a fresh host-to-device copy on every exchange would block the
    # host until the stream drains.
    _cache: dict = dataclasses.field(default_factory=dict, compare=False,
                                     hash=False, repr=False)

    def cached_index(self, key: tuple, device: torch.device,
                     build: Callable[[], np.ndarray],
                     dtype: torch.dtype = torch.int64) -> torch.Tensor:
        """``build()`` as an integer tensor on ``device``, memoized by
        ``key``."""
        k = ("index", key, str(device), dtype)
        t = self._cache.get(k)
        if t is None:
            t = torch.from_numpy(np.asarray(build(), np.int64)).to(
                device=device, dtype=dtype)
            self._cache[k] = t
        return t

    @property
    def size(self) -> int:
        return int(np.prod(self.shape)) if self.shape else 1

    @property
    def local_size(self) -> int:
        """Ranks held by this process: all of them."""
        return self.size

    @property
    def local_shape(self) -> Tuple[int, ...]:
        """The held ranks' extent along each axis: the whole shape."""
        return self.shape

    def local_coords(self) -> np.ndarray:
        """``[local_size, n_axes]`` coordinates of the ranks held here."""
        return self.coords()

    def axis_size(self, axes: AxisNames) -> int:
        sizes = dict(zip(self.axis_names, self.shape))
        return int(np.prod([sizes[a] for a in _as_tuple(axes)]))

    def coords(self) -> np.ndarray:
        """``[R, n_axes]`` coordinates of every rank (row-major)."""
        return np.stack(np.unravel_index(np.arange(self.size), self.shape),
                        axis=1).astype(np.int64) if self.shape else \
            np.zeros((1, 0), np.int64)

    def sub(self, axes: Sequence[str]) -> "LocalMesh":
        """The mesh of ``axes`` alone (the manual axes of an island)."""
        axes = tuple(axes)
        sub = self._cache.get(("sub", axes))
        if sub is None:
            sizes = dict(zip(self.axis_names, self.shape))
            order = [a for a in self.axis_names if a in axes]
            if order != list(axes):
                raise ValueError(f"axes {axes} must be mesh axes in mesh "
                                 f"order {self.axis_names}")
            sub = LocalMesh(tuple(sizes[a] for a in axes), axes, self.device)
            self._cache[("sub", axes)] = sub
        return sub


def _ravel(coords: Sequence[int], shape: Sequence[int]) -> int:
    r = 0
    for c, n in zip(coords, shape):
        r = r * n + int(c)
    return r


@dataclasses.dataclass(frozen=True, eq=False)
class ProcessMesh:
    """Named axes over ``R = prod(shape)`` ranks, one OS process each; this
    process holds rank ``rank`` (row-major over the axes, as a
    ``LocalMesh``), at coordinates ``rank_coords``.

    A per-rank tensor is a stack of one, ``[1, ...]``.  Exchanges go over
    ``torch.distributed`` process groups, one per set of axes: the ranks
    that share every other coordinate (``launch/procs.py`` creates them all
    at start-up, in the same order on every rank, since creating a group is
    collective over the world).  ``backend`` is ``"gloo"`` or ``"nccl"``;
    under gloo a CUDA tensor is staged through pinned host memory inside
    each collective (gloo's transport is the host), under NCCL it stays on
    the card.  A sub-mesh (``sub``) is the ranks that share this process's
    coordinates on the axes left out; it reuses the root's groups.
    """

    shape: Tuple[int, ...]
    axis_names: Tuple[str, ...]
    device: torch.device
    rank: int
    backend: str
    # the root mesh (the world): its shape, axis names and this process's
    # coordinates there; sorted member world ranks -> process group
    root_shape: Tuple[int, ...]
    root_axes: Tuple[str, ...]
    root_coords: Tuple[int, ...]
    groups: dict = dataclasses.field(repr=False)
    _cache: dict = dataclasses.field(default_factory=dict, repr=False)

    cached_index = LocalMesh.cached_index
    size = LocalMesh.size
    axis_size = LocalMesh.axis_size
    coords = LocalMesh.coords

    @property
    def local_size(self) -> int:
        """Ranks held by this process: its own."""
        return 1

    @property
    def local_shape(self) -> Tuple[int, ...]:
        """The held ranks' extent along each axis: 1 on every axis."""
        return (1,) * len(self.shape)

    @property
    def rank_coords(self) -> Tuple[int, ...]:
        """This process's coordinates on this mesh's axes."""
        return tuple(self.root_coords[self.root_axes.index(a)]
                     for a in self.axis_names)

    def local_coords(self) -> np.ndarray:
        """``[1, n_axes]``: this process's coordinates."""
        return np.asarray([self.rank_coords], np.int64).reshape(
            1, len(self.axis_names))

    def sub(self, axes: Sequence[str]) -> "ProcessMesh":
        """The mesh of ``axes`` alone: the ranks sharing this process's
        coordinates on every other axis."""
        axes = tuple(axes)
        sub = self._cache.get(("sub", axes))
        if sub is None:
            if [a for a in self.axis_names if a in axes] != list(axes):
                raise ValueError(f"axes {axes} must be mesh axes in mesh "
                                 f"order {self.axis_names}")
            shape = tuple(self.axis_size(a) for a in axes)
            mine = [self.root_coords[self.root_axes.index(a)] for a in axes]
            sub = dataclasses.replace(
                self, shape=shape, axis_names=axes, rank=_ravel(mine, shape),
                _cache={})
            self._cache[("sub", axes)] = sub
        return sub

    def members(self, axes: AxisNames) -> Tuple[int, ...]:
        """World ranks of this process's group over ``axes``, by combined
        index over ``axes`` (first axis major)."""
        axes = _as_tuple(axes)
        key = ("members", axes)
        out = self._cache.get(key)
        if out is None:
            pos = [self.root_axes.index(a) for a in axes]
            sizes = [self.root_shape[q] for q in pos]
            out = []
            for j in range(int(np.prod(sizes)) if sizes else 1):
                c = list(self.root_coords)
                for q, v in zip(pos, np.unravel_index(j, sizes)
                                if sizes else ()):
                    c[q] = int(v)
                out.append(_ravel(c, self.root_shape))
            out = tuple(out)
            self._cache[key] = out
        return out

    def group(self, axes: AxisNames):
        """The process group over ``axes``; None for a group of one rank
        in a larger world (its collectives are local)."""
        key = tuple(sorted(self.members(axes)))
        if key in self.groups:
            return self.groups[key]
        if len(key) == 1:
            return None
        raise KeyError(f"no process group for ranks {key}")


def make_mesh(shape: Tuple[int, ...], axes: Tuple[str, ...],
              device: Union[str, torch.device] = "cuda") -> LocalMesh:
    """A ``LocalMesh`` of ``shape`` named ``axes`` on ``device``."""
    shape = tuple(int(s) for s in shape)
    axes = tuple(axes)
    if len(shape) != len(axes) or min(shape, default=1) < 1:
        raise ValueError(f"bad mesh shape {shape} for axes {axes}")
    return LocalMesh(shape, axes, resolve_device(device))


def parse_mesh(text: str) -> Tuple[int, int, int]:
    """A command line's ``POD,DATA`` or ``POD,DATA,MODEL`` as a (pod,
    data, model) shape (model 1 when left out); raises ``ValueError``."""
    try:
        shape = tuple(int(v) for v in text.split(","))
    except ValueError:
        shape = ()
    if len(shape) not in (2, 3) or min(shape) < 1:
        raise ValueError(f"--mesh {text!r}: give POD,DATA or POD,DATA,MODEL")
    return shape + (1,) * (3 - len(shape))


def make_production_mesh(*, multi_pod: bool = False, process: bool = False,
                         device: Union[str, torch.device] = "cuda",
                         backend: Optional[str] = None,
                         init_method: Optional[str] = None,
                         dry: bool = False, rank: int = 0):
    """The reference's production shapes: ``(pod 2, data 16, model 16)``
    with ``multi_pod``, else ``(data 16, model 16)``.  ``process=False``
    stacks them on ``device`` as a ``LocalMesh``; ``process=True`` joins
    this process to a world of one process per rank
    (``procs.init_process_mesh``, which needs ``backend`` and reads the
    rank from the environment) and returns its ``ProcessMesh``; ``dry``
    returns rank ``rank``'s ``dry_mesh`` and starts nothing."""
    shape = (2, 16, 16) if multi_pod else (16, 16)
    axes = ("pod", "data", "model") if multi_pod else ("data", "model")
    if dry:
        return dry_mesh(shape, axes, rank)
    if not process:
        return make_mesh(shape, axes, device)
    if backend is None:
        raise ValueError("a ProcessMesh needs an explicit backend "
                         "('gloo' or 'nccl')")
    from .procs import init_process_mesh

    return init_process_mesh(shape, axes, backend, device, init_method)


def dry_mesh(shape: Tuple[int, ...], axes: Tuple[str, ...],
             rank: int = 0) -> ProcessMesh:
    """Rank ``rank``'s ``ProcessMesh`` of ``shape`` with no world: on the
    meta device, backend ``"dry"``, no process group.  Its collectives
    report to ``roofline.count()`` as a joined rank's do and return empty
    meta tensors of the right shapes; nothing is started."""
    shape = tuple(int(s) for s in shape)
    coords = tuple(int(c) for c in np.unravel_index(int(rank), shape))
    return ProcessMesh(shape=shape, axis_names=tuple(axes),
                       device=torch.device("meta"), rank=int(rank),
                       backend="dry", root_shape=shape,
                       root_axes=tuple(axes), root_coords=coords, groups={})


def dp_axes(mesh) -> Tuple[str, ...]:
    """Axes the batch shards over (everything except the TP axis)."""
    return tuple(a for a in mesh.axis_names if a != "model")


def slow_axis(mesh) -> Optional[str]:
    return "pod" if "pod" in mesh.axis_names else None


def _group(mesh: LocalMesh, axes: Tuple[str, ...]):
    """For each rank: its combined index over ``axes`` (first axis major)
    and the rank holding each combined index in its group (the ranks that
    share its coordinates on every other axis)."""
    coords = mesh.coords()
    pos = [mesh.axis_names.index(a) for a in axes]
    sizes = [mesh.shape[p] for p in pos]
    n = int(np.prod(sizes)) if sizes else 1
    combined = np.zeros(mesh.size, np.int64)
    for p, s in zip(pos, sizes):
        combined = combined * s + coords[:, p]
    members = np.empty((mesh.size, n), np.int64)
    sub = np.stack(np.unravel_index(np.arange(n), sizes), axis=1) \
        if sizes else np.zeros((1, 0), np.int64)
    strides = np.array([int(np.prod(mesh.shape[k + 1:]))
                        for k in range(len(mesh.shape))], np.int64)
    for j in range(n):
        c = coords.copy()
        c[:, pos] = sub[j]
        members[:, j] = c @ strides
    return combined, members


def axis_index(mesh, axis: str) -> torch.Tensor:
    """``[local_size]`` int64: each held rank's coordinate along ``axis``."""
    return mesh.cached_index(
        ("axis_index", axis), mesh.device,
        lambda: mesh.local_coords()[:, mesh.axis_names.index(axis)])


def all_to_all(mesh, x: torch.Tensor, axes: AxisNames, axis: int = 0,
               span: str = "procmesh.all_to_all") -> torch.Tensor:
    """Tiled all-to-all over ``axes`` on a stacked ``x [local_size, ...]``.

    ``axis`` is the per-rank split (= concat) dimension, whose size must be
    a multiple of ``n = prod(sizes of axes)``.  Per rank it is
    ``lax.all_to_all(x, axes, axis, axis, tiled=True)``: chunk ``j`` goes to
    the group member with combined index ``j``, and the chunk received from
    member ``j`` lands at position ``j``.  On a ``ProcessMesh`` it runs
    inside the profiler range ``span``, its backward inside ``span.bwd``.
    """
    axes = _as_tuple(axes)
    r = mesh.local_size
    if x.shape[0] != r:
        raise ValueError(f"leading dim {x.shape[0]} != {r} ranks")
    n = mesh.axis_size(axes) if axes else 1
    k = axis + 1
    size = x.shape[k]
    if size % n:
        raise ValueError(f"dim {axis} of size {size} does not split {n} ways")
    if isinstance(mesh, ProcessMesh):
        return _AllToAll.apply(mesh, x, axes, k, n, span)
    # out[rank, ..., j, ...] = x[members[rank, j], ..., combined[rank], ...]
    xv = x.reshape(*x.shape[:k], n, size // n, *x.shape[k + 1:])
    src_rank = mesh.cached_index(("a2a_members", axes), x.device,
                                 lambda: _group(mesh, axes)[1])
    src_rank = src_rank.reshape(r, *([1] * (k - 1)), n)
    src_chunk = mesh.cached_index(("a2a_combined", axes), x.device,
                                  lambda: _group(mesh, axes)[0])
    src_chunk = src_chunk.reshape(r, *([1] * k))
    mid = [torch.arange(x.shape[i], device=x.device).reshape(
        *([1] * i), x.shape[i], *([1] * (k - i))) for i in range(1, k)]
    out = xv[(src_rank, *mid, src_chunk)]
    return out.reshape(x.shape)


def all_gather(mesh, x: torch.Tensor, axes: AxisNames,
               out_device=None, span: str = "procmesh.all_to_all"
               ) -> torch.Tensor:
    """``[local_size, n, ...]``: for each held rank, the ``x`` of every
    member of its group over ``axes``, by combined index (an all-to-all of
    ``n`` copies, in the profiler range ``span``), on ``out_device``
    (default: ``x``'s).  A gather to the host under gloo, whose transport
    is host memory, never lands on the card."""
    axes = _as_tuple(axes)
    if isinstance(mesh, ProcessMesh) and mesh.backend == "dry":
        out_device = None       # a dry mesh keeps every tensor on meta
    if out_device is not None:
        out_device = torch.device(out_device)
        if out_device.type == "cpu" and isinstance(mesh, ProcessMesh) \
                and mesh.backend == "gloo":
            x = x.to(out_device)
    n = mesh.axis_size(axes) if axes else 1
    rep = x.unsqueeze(1).expand(x.shape[0], n, *x.shape[1:]).contiguous()
    out = all_to_all(mesh, rep, axes, axis=0, span=span)
    return out if out_device is None else out.to(out_device)


def member_sum(parts, device=None) -> torch.Tensor:
    """``parts`` (a tensor ``[n, ...]`` or an iterable of tensors, a
    group's members in order, as ``all_gather`` gives them) added in that
    order on ``device`` (default: theirs), one part moved there at a time:
    every process of the group that gathered them gets the same bits."""
    acc = None
    for part in parts:
        if device is not None:
            part = part.to(device)
        acc = part if acc is None else acc + part
    return acc


def all_ranks(mesh: ProcessMesh, value: int) -> Tuple[int, ...]:
    """Every process's integer ``value``, by world rank: collective over
    the whole mesh, so it is also a barrier (no process returns before
    every process has called it)."""
    t = torch.tensor([[int(value)]], dtype=torch.int64, device=mesh.device)
    with torch.no_grad():
        return tuple(all_gather(mesh, t, mesh.axis_names)[0, :, 0].tolist())


def ppermute(mesh, x: torch.Tensor, axis: str,
             pairs: Sequence[Tuple[int, int]]) -> torch.Tensor:
    """``lax.ppermute`` over ``axis`` on a stacked ``x [local_size, ...]``:
    the rank at coordinate ``d`` receives from the rank at ``s`` for each
    ``(s, d)`` (same coordinates on every other axis); ranks that receive
    nothing get zeros."""
    pairs = tuple((int(s), int(d)) for s, d in pairs)
    if isinstance(mesh, ProcessMesh):
        return _PPermute.apply(mesh, x, axis, pairs)

    def routes() -> np.ndarray:
        """``[2, n]``: receiving ranks, then the rank each receives from."""
        coords = mesh.coords()
        a = mesh.axis_names.index(axis)
        stride = int(np.prod(mesh.shape[a + 1:]))
        src_of = {d: s for s, d in pairs}
        dst_ranks, src_ranks = [], []
        for rank in range(mesh.size):
            s = src_of.get(int(coords[rank, a]))
            if s is not None:
                dst_ranks.append(rank)
                src_ranks.append(rank + (s - int(coords[rank, a])) * stride)
        return np.array([dst_ranks, src_ranks], np.int64).reshape(2, -1)

    idx = mesh.cached_index(("ppermute", axis, pairs), x.device, routes)
    out = torch.zeros_like(x)
    if idx.shape[1]:
        out.index_copy_(0, idx[0], x.index_select(0, idx[1]))
    return out


def pmean(mesh, x: torch.Tensor, axes: AxisNames) -> torch.Tensor:
    """``lax.pmean`` over ``axes`` on a stacked ``x [local_size, ...]``.

    On a ``ProcessMesh`` it is an ``all_reduce`` sum over the group divided
    by the group's size; its summation order is the backend's, so it may
    differ from the ``LocalMesh``'s ``mean`` in the last bits (within a
    relative 1e-6 in f32)."""
    axes = _as_tuple(axes)
    if isinstance(mesh, ProcessMesh):
        return _PMean.apply(mesh, x, axes)
    dims = [mesh.axis_names.index(a) for a in axes]
    xm = x.reshape(*mesh.shape, *x.shape[1:])
    return xm.mean(dim=dims, keepdim=True).expand_as(xm).reshape(x.shape)


# -- the process forms ----------------------------------------------------------
#
# Each runs inside a profiler range named ``procmesh.<collective>`` (host
# staging included), its backward inside ``procmesh.<collective>.bwd``; the
# ranges read the exchange's and the gradient sync's share of a traced step.

def _staged(mesh: ProcessMesh, x: torch.Tensor) -> torch.Tensor:
    """``x`` where the backend can move it: under gloo a CUDA tensor is
    copied to pinned host memory (gloo's transport is the host)."""
    if mesh.backend == "gloo" and x.is_cuda:
        host = torch.empty(x.shape, dtype=x.dtype, pin_memory=True)
        host.copy_(x)
        return host
    return x.contiguous()


def _nbytes(t: torch.Tensor) -> int:
    return t.numel() * t.element_size()


def _bytes(t: torch.Tensor) -> torch.Tensor:
    """A contiguous tensor's bytes (the transport moves them unchanged,
    whatever the dtype)."""
    return t.reshape(-1).view(torch.uint8)


def _proc_all_to_all(mesh: ProcessMesh, x: torch.Tensor,
                     axes: Tuple[str, ...], k: int, n: int,
                     span: str = "procmesh.all_to_all") -> torch.Tensor:
    roofline.collective("all-to-all", axes, n, _nbytes(x))
    with torch.profiler.record_function(span), roofline.quiet():
        if mesh.backend == "dry":
            return torch.empty_like(x)
        group = mesh.group(axes)
        if group is None:
            return x.clone()
        members = mesh.members(axes)
        size = x.shape[k]
        # [n, ...]: chunk j (for member j) leading
        xv = x.reshape(*x.shape[:k], n, size // n, *x.shape[k + 1:]) \
            .movedim(k, 0)
        # the group's ranks are its sorted world ranks
        order = sorted(range(n), key=lambda j: members[j])
        if order != list(range(n)):
            xv = xv[order]
        send = _staged(mesh, xv)
        recv = torch.empty_like(send)
        torch_dist.all_to_all_single(_bytes(recv), _bytes(send), group=group)
        if order != list(range(n)):
            back = torch.empty_like(recv)
            back[order] = recv
            recv = back
        out = recv.to(x.device, non_blocking=False).movedim(0, k)
        return out.reshape(x.shape)


def _proc_ppermute(mesh: ProcessMesh, x: torch.Tensor, axis: str,
                   pairs: Tuple[Tuple[int, int], ...],
                   span: str = "procmesh.ppermute") -> torch.Tensor:
    a = mesh.axis_names.index(axis)
    me = mesh.rank_coords[a]
    dst = {s: d for s, d in pairs}.get(me)
    src = {d: s for s, d in pairs}.get(me)
    if dst is not None and dst != me:     # what this rank sends
        roofline.collective("collective-permute", (axis,),
                            mesh.axis_size(axis), _nbytes(x))
    with torch.profiler.record_function(span), roofline.quiet():
        if mesh.backend == "dry":
            return torch.empty_like(x)
        peers = mesh.members((axis,))        # world rank at each coordinate
        # the world's group (its ranks are the world ranks), created with
        # the mesh's collective timeout
        world = mesh.groups.get(tuple(range(int(np.prod(mesh.root_shape)))))
        out = torch.zeros_like(x)
        if src == me:
            out.copy_(x)
        ops = []
        if dst is not None and dst != me:
            send = _staged(mesh, x)
            ops.append(torch_dist.P2POp(torch_dist.isend, _bytes(send),
                                        peers[dst], group=world))
        recv = None
        if src is not None and src != me:
            recv = torch.empty(x.shape, dtype=x.dtype,
                               device="cpu" if mesh.backend == "gloo"
                               else x.device,
                               pin_memory=mesh.backend == "gloo"
                               and x.is_cuda)
            ops.append(torch_dist.P2POp(torch_dist.irecv, _bytes(recv),
                                        peers[src], group=world))
        if ops:
            for req in torch_dist.batch_isend_irecv(ops):
                req.wait()
        if recv is not None:
            out.copy_(recv)
        return out


def _proc_pmean(mesh: ProcessMesh, x: torch.Tensor,
                axes: Tuple[str, ...], span: str = "procmesh.pmean"
                ) -> torch.Tensor:
    roofline.collective("all-reduce", axes, mesh.axis_size(axes), _nbytes(x))
    with torch.profiler.record_function(span), roofline.quiet():
        if mesh.backend == "dry":
            return torch.empty_like(x)
        group = mesh.group(axes)
        if group is None:
            return x.clone()
        buf = _staged(mesh, x)
        if buf is x:
            buf = x.clone()
        torch_dist.all_reduce(buf, torch_dist.ReduceOp.SUM, group=group)
        return (buf.to(x.device) / mesh.axis_size(axes)).to(x.dtype)


class _AllToAll(torch.autograd.Function):
    """The tiled ``all_to_all`` over the same axes is its own transpose."""

    @staticmethod
    def forward(ctx, mesh, x, axes, k, n, span):
        ctx.args = (mesh, axes, k, n, span)
        return _proc_all_to_all(mesh, x, axes, k, n, span)

    @staticmethod
    def backward(ctx, g):
        mesh, axes, k, n, span = ctx.args
        return (None, _proc_all_to_all(mesh, g.contiguous(), axes, k, n,
                                       f"{span}.bwd"),
                None, None, None, None)


class _PPermute(torch.autograd.Function):
    """``ppermute``'s transpose sends each cotangent back along its pair:
    ``(s, d)`` becomes ``(d, s)``, and a rank that sent nothing gets
    zeros."""

    @staticmethod
    def forward(ctx, mesh, x, axis, pairs):
        ctx.args = (mesh, axis, tuple((d, s) for s, d in pairs))
        return _proc_ppermute(mesh, x, axis, pairs)

    @staticmethod
    def backward(ctx, g):
        mesh, axis, back = ctx.args
        return (None, _proc_ppermute(mesh, g.contiguous(), axis, back,
                                     "procmesh.ppermute.bwd"), None, None)


def _pmean_backward(mesh: ProcessMesh, g: torch.Tensor,
                    axes: Tuple[str, ...]) -> torch.Tensor:
    """``pmean``'s transpose: the mean of the group's cotangents (every
    member's loss depends on every member's input through the mean)."""
    return _proc_pmean(mesh, g.contiguous(), axes, "procmesh.pmean.bwd")


class _PMean(torch.autograd.Function):

    @staticmethod
    def forward(ctx, mesh, x, axes):
        ctx.args = (mesh, axes)
        return _proc_pmean(mesh, x, axes)

    @staticmethod
    def backward(ctx, g):
        mesh, axes = ctx.args
        return None, _pmean_backward(mesh, g, axes), None
