"""AdamW with decoupled weight decay + global-norm clipping, in place.

Counterpart of ``src/repro/optim/adamw.py``, term by term: the global norm
of the gradients (reported before clipping), the clip scale
``min(1, clip_norm / max(norm, 1e-9))``, bias-corrected f32 moments, and
weight decay on every parameter.  The reference returns new pytrees; here
the parameters and the moments are updated in place under ``no_grad``,
because a functional update of megatron-moe-32e's full-width state would
need another copy of it (41 GB at two layers).  Parameters, gradients and
moments are dictionaries keyed by parameter name
(``dict(module.named_parameters())``).

Two multi-tensor passes do the work (``kernels/adamw``): ``sq_norm``, each
gradient's sum of squares, and ``adamw_step``, every leaf's update in one
fused pass, the clip scale read from the norm on the device.  On the card
each is one launch a dtype group; on the CPU, and wherever
``use_kernel=False``, each is the plain per-leaf code
(``kernels/adamw/ref.py``).  The update runs in the ``adamw.update``
span, inside ``train.optimizer``; the trace counter ``adamw.elems`` counts
the elements updated.

On a ``ProcessMesh`` each process holds its shard of every parameter, its
gradient and its moments; the update is elementwise, so it runs on the
shard unchanged, and the global norm (hence the clip scale) is the whole
tree's: ``adamw_update`` takes the mesh and the parameters' specs for it.
"""

from __future__ import annotations

import dataclasses
from typing import Dict, NamedTuple, Optional

import numpy as np
import torch

from .. import trace
from ..kernels.adamw import adamw_step, adamw_step_ref, sq_norm, sq_norm_ref

__all__ = ["AdamWConfig", "OptState", "init_opt_state", "adamw_update",
           "global_norm"]

Tensors = Dict[str, torch.Tensor]


@dataclasses.dataclass(frozen=True)
class AdamWConfig:
    b1: float = 0.9
    b2: float = 0.95
    eps: float = 1e-8
    weight_decay: float = 0.1
    clip_norm: Optional[float] = 1.0


class OptState(NamedTuple):
    m: Tensors
    v: Tensors
    count: torch.Tensor          # int32 scalar, on the host


def _named(params) -> Tensors:
    if isinstance(params, torch.nn.Module):
        return dict(params.named_parameters())
    return dict(params)


def init_opt_state(params) -> OptState:
    """Zero f32 moments beside each parameter (a module or a dict)."""
    named = _named(params)
    zeros = {k: torch.zeros(p.shape, dtype=torch.float32, device=p.device)
             for k, p in named.items()}
    return OptState(m=zeros,
                    v={k: torch.zeros_like(z) for k, z in zeros.items()},
                    count=torch.zeros((), dtype=torch.int32))


def _kernel_ready(t: torch.Tensor) -> torch.Tensor:
    """``t``, or a contiguous copy where the AdamW kernels could not read it
    in place: a gradient that is a view into a larger one (hymba's fused
    projections' slices) or, on the card, one that does not start on 16
    bytes."""
    if t.is_contiguous() and (t.device.type != "cuda"
                              or t.data_ptr() % 16 == 0):
        return t
    return t.clone(memory_format=torch.contiguous_format)


def global_norm(tensors, mesh=None, specs: Optional[Dict] = None,
                use_kernel: bool = True) -> torch.Tensor:
    """sqrt of the sum of squares of every tensor, in f32, keys in sorted
    order (the order of a JAX dict pytree).

    On a ``ProcessMesh`` (``mesh``, with ``specs`` the ``{name: spec}`` of
    ``launch/shardings.module_specs``) ``tensors`` are this process's
    shards: a sharded tensor's square sum is the sum of its group's shards'
    (gathered, added in member order), a replicated one counts once, so
    every process gets the same bits.  ``use_kernel=False``: the plain
    sums of squares."""
    from ..launch.mesh import ProcessMesh, all_gather, member_sum
    from ..launch.shardings import sharded_axes

    named = _named(tensors)
    if use_kernel:
        sums = sq_norm([_kernel_ready(t) for t in named.values()])
    else:
        sums = sq_norm_ref(list(named.values()))
    sums = dict(zip(named, sums.unbind(0)))
    if isinstance(mesh, ProcessMesh):
        groups: Dict[tuple, list] = {}
        for k in sorted(named):
            axes = sharded_axes(mesh, specs[k])
            if axes:
                groups.setdefault(axes, []).append(k)
        for axes, keys in groups.items():
            parts = all_gather(mesh, torch.stack([sums[k] for k in keys])[None],
                               axes)[0]
            sums.update(zip(keys, member_sum(parts)))
    total = None
    for k in sorted(named):
        total = sums[k] if total is None else total + sums[k]
    return torch.sqrt(total)


@torch.no_grad()
def adamw_update(grads, state: OptState, params, lr: float,
                 cfg: AdamWConfig = AdamWConfig(), mesh=None,
                 specs: Optional[Dict] = None, use_kernel: bool = True):
    """Update ``params`` and ``state``'s moments in place from ``grads``.

    Returns (params, new state, grad norm before clipping); the new state
    holds the same moment tensors and the incremented count.  ``mesh`` and
    ``specs``: the norm over a ``ProcessMesh``'s shards (``global_norm``).
    ``use_kernel=False`` runs the plain versions of both kernels."""
    with trace.span("train.optimizer"):
        named = _named(params)
        grads = _named(grads)
        if use_kernel:
            grads = {k: _kernel_ready(g) for k, g in grads.items()}
        gnorm = global_norm(grads, mesh, specs, use_kernel)
        count = state.count + 1
        c = np.float32(int(count))
        bc1 = float(np.float32(1) - np.float32(cfg.b1) ** c)
        bc2 = float(np.float32(1) - np.float32(cfg.b2) ** c)
        trace.count("adamw.elems", sum(p.numel() for p in named.values()))
        with trace.span("adamw.update"):
            (adamw_step if use_kernel else adamw_step_ref)(
                list(named.values()), [grads[k] for k in named],
                [state.m[k] for k in named], [state.v[k] for k in named],
                lr=float(lr), b1=cfg.b1, b2=cfg.b2, eps=cfg.eps,
                weight_decay=cfg.weight_decay, bc1=bc1, bc2=bc2,
                norm=gnorm, clip_norm=cfg.clip_norm)
    return params, OptState(m=state.m, v=state.v, count=count), gnorm
