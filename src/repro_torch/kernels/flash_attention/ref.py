"""Plain PyTorch version of flash_attention (the kernel's oracle)."""

from __future__ import annotations

import math
from typing import Optional

import torch

__all__ = ["attention_ref"]


def attention_ref(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
                  causal: bool = True,
                  window: Optional[int] = None) -> torch.Tensor:
    """q: [B, H, S, D]; k/v: [B, K, S, D] (GQA repeat here).

    f32 math with the finite -1e30 mask, output in q's dtype."""
    b, h, s, d = q.shape
    rep = h // k.shape[1]
    k = k.repeat_interleave(rep, dim=1)
    v = v.repeat_interleave(rep, dim=1)
    scores = torch.einsum("bhqd,bhkd->bhqk", q.float(), k.float()) \
        / math.sqrt(d)
    qpos = torch.arange(s, device=q.device)[:, None]
    kpos = torch.arange(s, device=q.device)[None, :]
    mask = torch.ones((s, s), dtype=torch.bool, device=q.device)
    if causal:
        mask &= kpos <= qpos
    if window is not None:
        mask &= kpos > qpos - window
    # in place: at the serving shapes the scores are gigabytes
    scores.masked_fill_(~mask, -1e30)
    scores.sub_(scores.amax(-1, keepdim=True)).exp_()
    scores.div_(scores.sum(-1, keepdim=True))
    out = torch.einsum("bhqk,bhkd->bhqd", scores, v.float())
    return out.to(q.dtype)
