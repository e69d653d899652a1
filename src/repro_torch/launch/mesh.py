"""The local mesh: every rank of a ``("pod", "data", "model")`` mesh stacked
on one device.

The JAX package runs its expert-parallel program under ``shard_map`` on a
mesh of devices.  Here one card holds all ranks: a per-rank tensor of shape
``[...]`` becomes a stacked tensor ``[R, ...]`` whose leading index is the
rank, ranks in row-major order over the mesh axes (slow axis major), the
same order as the JAX mesh's devices.  The collectives below act on stacked
tensors and are device-side copies; they compute what ``lax.all_to_all``,
``lax.ppermute``, ``lax.axis_index`` and ``lax.pmean`` compute per rank.
"""

from __future__ import annotations

import dataclasses
from typing import Callable, Optional, Sequence, Tuple, Union

import numpy as np
import torch

__all__ = ["LocalMesh", "make_mesh", "resolve_device", "dp_axes",
           "slow_axis", "all_to_all", "ppermute", "axis_index", "pmean"]

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


def make_mesh(shape: Tuple[int, ...], axes: Tuple[str, ...],
              device: Union[str, torch.device] = "cuda") -> LocalMesh:
    """A ``LocalMesh`` of ``shape`` named ``axes`` on ``device``."""
    shape = tuple(int(s) for s in shape)
    axes = tuple(axes)
    if len(shape) != len(axes) or min(shape, default=1) < 1:
        raise ValueError(f"bad mesh shape {shape} for axes {axes}")
    return LocalMesh(shape, axes, resolve_device(device))


def dp_axes(mesh: LocalMesh) -> Tuple[str, ...]:
    """Axes the batch shards over (everything except the TP axis)."""
    return tuple(a for a in mesh.axis_names if a != "model")


def slow_axis(mesh: LocalMesh) -> Optional[str]:
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


def axis_index(mesh: LocalMesh, axis: str) -> torch.Tensor:
    """``[R]`` int64: each rank's coordinate along ``axis``."""
    return mesh.cached_index(
        ("axis_index", axis), mesh.device,
        lambda: mesh.coords()[:, mesh.axis_names.index(axis)])


def all_to_all(mesh: LocalMesh, x: torch.Tensor, axes: AxisNames,
               axis: int = 0) -> torch.Tensor:
    """Tiled all-to-all over ``axes`` on a stacked ``x [R, ...]``.

    ``axis`` is the per-rank split (= concat) dimension, whose size must be
    a multiple of ``n = prod(sizes of axes)``.  Per rank it is
    ``lax.all_to_all(x, axes, axis, axis, tiled=True)``: chunk ``j`` goes to
    the group member with combined index ``j``, and the chunk received from
    member ``j`` lands at position ``j``.
    """
    axes = _as_tuple(axes)
    r = mesh.size
    if x.shape[0] != r:
        raise ValueError(f"leading dim {x.shape[0]} != {r} ranks")
    n = mesh.axis_size(axes) if axes else 1
    k = axis + 1
    size = x.shape[k]
    if size % n:
        raise ValueError(f"dim {axis} of size {size} does not split {n} ways")
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


def ppermute(mesh: LocalMesh, x: torch.Tensor, axis: str,
             pairs: Sequence[Tuple[int, int]]) -> torch.Tensor:
    """``lax.ppermute`` over ``axis`` on a stacked ``x [R, ...]``: the rank
    at coordinate ``d`` receives from the rank at ``s`` for each ``(s, d)``
    (same coordinates on every other axis); ranks that receive nothing get
    zeros."""
    pairs = tuple((int(s), int(d)) for s, d in pairs)

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


def pmean(mesh: LocalMesh, x: torch.Tensor, axes: AxisNames) -> torch.Tensor:
    """``lax.pmean`` over ``axes`` on a stacked ``x [R, ...]``."""
    axes = _as_tuple(axes)
    dims = [mesh.axis_names.index(a) for a in axes]
    xm = x.reshape(*mesh.shape, *x.shape[1:])
    return xm.mean(dim=dims, keepdim=True).expand_as(xm).reshape(x.shape)
