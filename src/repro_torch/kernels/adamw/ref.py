"""Plain PyTorch versions of the AdamW kernels: each leaf's f32 sum of
squares, and the update one leaf at a time, in place (the port's AdamW as
it was before its kernels, term by term the reference's
``src/repro/optim/adamw.py``)."""

from __future__ import annotations

from typing import Optional, Sequence

import torch

__all__ = ["sq_norm_ref", "adamw_step_ref"]


def sq_norm_ref(tensors: Sequence[torch.Tensor]) -> torch.Tensor:
    """``[len(tensors)]`` f32: each tensor's sum of squares in f32."""
    if not tensors:
        return torch.zeros(0)
    return torch.stack([torch.sum(torch.square(t.float())) for t in tensors])


def adamw_step_ref(params: Sequence[torch.Tensor],
                   grads: Sequence[torch.Tensor],
                   ms: Sequence[torch.Tensor], vs: Sequence[torch.Tensor], *,
                   lr: float, b1: float, b2: float, eps: float,
                   weight_decay: float, bc1: float, bc2: float,
                   norm: Optional[torch.Tensor] = None,
                   clip_norm: Optional[float] = None) -> None:
    """Update each parameter and its f32 moments in place from its
    gradient, clipped to ``clip_norm`` by the gradients' global ``norm``
    (no clip when ``clip_norm`` is None); ``bc1`` and ``bc2`` are the bias
    corrections of this step."""
    scale = None
    if clip_norm is not None:
        scale = torch.clamp(clip_norm / torch.clamp(norm, min=1e-9), max=1.0)
    for p, g, m, v in zip(params, grads, ms, vs):
        g32 = g.float()
        if scale is not None:
            g32 = g32 * scale.to(g32.device)
        m.mul_(b1).add_(g32, alpha=1 - b1)
        v.mul_(b2).add_(torch.square(g32).mul_(1 - b2))
        del g32
        p32 = p if p.dtype == torch.float32 else p.float()
        step = (m / bc1).div_(torch.sqrt(v / bc2).add_(eps))
        step.add_(p32, alpha=weight_decay)
        p32.sub_(step.mul_(lr))
        if p32 is not p:
            p.copy_(p32)
        del step, p32
