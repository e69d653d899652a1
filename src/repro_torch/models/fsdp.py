"""FSDP (ZeRO-3) on a ``ProcessMesh``: each weight stored over the DP axes,
gathered before use.

The reference's ``param_shardings`` adds the intra-pod DP axes to every
weight of two or more dims, on its first free dim they divide
(``launch/shardings.param_specs``); GSPMD gathers the weight before each
use and reduce-scatters its gradient.  Here a process holds its slice of
such a leaf (``convert.shard_module``; per layer, ``shardings.module_specs``)
and the model code gathers it at the start of each block, of the embedding
and of the head (``gather_params``; ``gather_top`` once a forward for the
model's own leaves, the tied embedding's lookup and head sharing one
gather): inside the function
that ``transformer._remat`` wraps, so a layer's whole weights live during
its forward and its recompute alone.  ``fsdp_gather`` is an
``autograd.Function``: forward, the peers' slices joined along the leaf's
FSDP dim by their coordinate over its axes (range ``procmesh.fsdp_gather``);
backward, the whole gradient's chunks summed in member order in f32 over
the peers that ran other rows, this process's chunk kept (a
reduce-scatter, ``procmesh.fsdp_gather.bwd``).  Those are its peers over
every FSDP axis but "model": under ``pure_dp`` the FSDP axes are
``("data", "model")`` while the batch goes over the DP axes alone, so a
process's model peers ran its rows and hold its gradient bit for bit,
and the reference's GSPMD sums over "data" and slices over "model" (a sum
over "model" too would add each row's gradient once per model peer).
The gradient sync (``launch/train._sync_grads``) then leaves the FSDP
axes out, as a spec that holds an axis tells it, and divides by the
batch's processes.  Serving gathers the same way, without autograd,
every layer and every decode step.  ``whole_shapes`` gives a module whose
FSDP leaves are meta tensors of the whole shapes, for code that reads
widths alone (a decode cache's sizes).
"""

from __future__ import annotations

import math
from typing import Dict, Tuple

import torch
from torch import nn

from ..launch.mesh import ProcessMesh
from .tp import _gather, _scatter_sum

__all__ = ["fsdp_gather", "gather_params", "gather_top", "whole_shapes"]


# the FSDP axis whose peers run the same rows (the batch never goes over it
# under FSDP): the gather's backward slices over it and sums over the rest
REPLICA_AXIS = "model"


class _FsdpGather(torch.autograd.Function):

    @staticmethod
    def forward(ctx, mesh, w, dim, axes):
        ctx.mesh, ctx.dim, ctx.axes = mesh, dim, axes
        parts = _gather(mesh, w.contiguous(), "procmesh.fsdp_gather", axes)
        return torch.cat(parts.unbind(0), dim)

    @staticmethod
    def backward(ctx, g):
        mesh, dim, axes = ctx.mesh, ctx.dim, ctx.axes
        sizes = [mesh.axis_size(a) for a in axes]
        chunks = g.reshape(*g.shape[:dim], -1, g.shape[dim] // math.prod(
            sizes), *g.shape[dim + 1:]).movedim(dim, 0)
        # [*sizes, ...]: chunk (c_1, ..., c_k) for the peer at those
        # coordinates; over the replica axis keep this process's own
        rest = chunks.shape[1:]
        chunks = chunks.reshape(*sizes, *rest)[tuple(
            mesh.rank_coords[mesh.axis_names.index(a)]
            if a == REPLICA_AXIS else slice(None) for a in axes)]
        summed = tuple(a for a in axes if a != REPLICA_AXIS)
        chunks = chunks.reshape(-1, *rest).contiguous()
        if not summed:
            return None, chunks[0], None, None
        return None, _scatter_sum(mesh, chunks, "procmesh.fsdp_gather.bwd",
                                  summed), None, None


def fsdp_gather(mesh: ProcessMesh, w: torch.Tensor, dim: int,
                axes: Tuple[str, ...]) -> torch.Tensor:
    """The whole leaf from this process's slice ``w`` of it along ``dim``
    over ``axes`` (collective over their group); its gradient summed in
    member order (f32) over the group's peers that ran other rows (every
    axis but "model"), this process's slice kept."""
    return _FsdpGather.apply(mesh, w, dim, tuple(axes))


class _Gathered:
    """``module`` with the leaves ``leaves`` (relative dotted names) in
    place of its own: attribute access as the module's, sub-modules
    wrapped where they hold such a leaf."""

    __slots__ = ("_module", "_leaves")

    def __init__(self, module: nn.Module, leaves: Dict[str, torch.Tensor]):
        object.__setattr__(self, "_module", module)
        object.__setattr__(self, "_leaves", leaves)

    def __getattr__(self, name):
        leaves = self._leaves
        if name in leaves:
            return leaves[name]
        sub = getattr(self._module, name)
        pre = name + "."
        inner = {k[len(pre):]: v for k, v in leaves.items()
                 if k.startswith(pre)}
        return _Gathered(sub, inner) if inner else sub


def _own(dist, prefix: str):
    """(relative name, dim, axes) of the FSDP leaves under ``prefix``."""
    layout = getattr(dist, "fsdp", None) if dist is not None else None
    if not layout:
        return []
    return [(k[len(prefix):], dim, axes) for k, (dim, axes) in
            layout.items() if k.startswith(prefix)]


def gather_params(module: nn.Module, dist, prefix: str):
    """``module`` (the parameters under ``prefix``, e.g. ``"blocks.3."``,
    of the model ``dist`` runs) with every FSDP leaf gathered
    (``fsdp_gather``); ``module`` itself without FSDP."""
    own = _own(dist, prefix)
    if not own:
        return module
    return _Gathered(module, {
        rel: fsdp_gather(dist.mesh, module.get_parameter(rel), dim, axes)
        for rel, dim, axes in own})


def gather_top(module: nn.Module, dist, names=None):
    """``module`` (the whole model ``dist`` runs) with its own FSDP leaves
    gathered (``names``, default every one: the embedding, the head, an
    encoder-decoder's position tables), not its blocks'; each gathered
    once for every use (the tied embedding's lookup and head)."""
    own = [(rel, dim, axes) for rel, dim, axes in _own(dist, "")
           if "." not in rel and (names is None or rel in names)]
    if not own:
        return module
    return _Gathered(module, {
        rel: fsdp_gather(dist.mesh, module.get_parameter(rel), dim, axes)
        for rel, dim, axes in own})


def whole_shapes(module: nn.Module, dist, prefix: str):
    """``module`` with each FSDP leaf under ``prefix`` a meta tensor of the
    whole leaf's shape (no collective)."""
    own = _own(dist, prefix)
    if not own:
        return module
    leaves = {}
    for rel, dim, axes in own:
        w = module.get_parameter(rel)
        shape = list(w.shape)
        shape[dim] *= dist.mesh.axis_size(axes)
        leaves[rel] = torch.empty(shape, dtype=w.dtype, device="meta")
    return _Gathered(module, leaves)
