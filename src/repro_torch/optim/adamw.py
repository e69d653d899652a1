"""AdamW with decoupled weight decay + global-norm clipping, in place.

Counterpart of ``src/repro/optim/adamw.py``, term by term: the global norm
of the gradients (reported before clipping), the clip scale
``min(1, clip_norm / max(norm, 1e-9))``, bias-corrected f32 moments, and
weight decay on every parameter.  The reference returns new pytrees; here
the parameters and the moments are updated in place under ``no_grad``, one
parameter at a time, because a functional update of megatron-moe-32e's
full-width state would need another copy of it (41 GB at two layers).
Parameters, gradients and moments are dictionaries keyed by parameter name
(``dict(module.named_parameters())``).

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


def global_norm(tensors, mesh=None, specs: Optional[Dict] = None
                ) -> torch.Tensor:
    """sqrt of the sum of squares of every tensor, in f32, keys in sorted
    order (the order of a JAX dict pytree).

    On a ``ProcessMesh`` (``mesh``, with ``specs`` the ``{name: spec}`` of
    ``launch/shardings.module_specs``) ``tensors`` are this process's
    shards: a sharded tensor's square sum is the sum of its group's shards'
    (gathered, added in member order), a replicated one counts once, so
    every process gets the same bits."""
    from ..launch.mesh import ProcessMesh, all_gather, member_sum
    from ..launch.shardings import sharded_axes

    named = _named(tensors)
    sums = {k: torch.sum(torch.square(named[k].float())) for k in named}
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
                 specs: Optional[Dict] = None):
    """Update ``params`` and ``state``'s moments in place from ``grads``.

    Returns (params, new state, grad norm before clipping); the new state
    holds the same moment tensors and the incremented count.  ``mesh`` and
    ``specs``: the norm over a ``ProcessMesh``'s shards (``global_norm``)."""
    named = _named(params)
    grads = _named(grads)
    gnorm = global_norm(grads, mesh, specs)
    scale = None
    if cfg.clip_norm is not None:
        scale = torch.clamp(cfg.clip_norm / torch.clamp(gnorm, min=1e-9),
                            max=1.0)
    count = state.count + 1
    c = np.float32(int(count))
    bc1 = float(np.float32(1) - np.float32(cfg.b1) ** c)
    bc2 = float(np.float32(1) - np.float32(cfg.b2) ** c)
    lr = float(lr)
    for k, p in named.items():
        g32 = grads[k].float()
        if scale is not None:
            g32 = g32 * scale.to(g32.device)
        m, v = state.m[k], state.v[k]
        m.mul_(cfg.b1).add_(g32, alpha=1 - cfg.b1)
        v.mul_(cfg.b2).add_(torch.square(g32).mul_(1 - cfg.b2))
        del g32
        p32 = p if p.dtype == torch.float32 else p.float()
        step = (m / bc1).div_(torch.sqrt(v / bc2).add_(cfg.eps))
        step.add_(p32, alpha=cfg.weight_decay)
        p32.sub_(step.mul_(lr))
        if p32 is not p:
            p.copy_(p32)
        del step, p32
    return params, OptState(m=state.m, v=state.v, count=count), gnorm
