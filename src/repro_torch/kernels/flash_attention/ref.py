"""Plain PyTorch versions of flash_attention and its backward (the kernels'
oracles)."""

from __future__ import annotations

import math
from typing import Optional, Tuple

import torch

__all__ = ["attention_ref", "attention_lse_ref", "flash_attention_bwd_ref"]


def _band(s: int, causal: bool, window: Optional[int], device
          ) -> torch.Tensor:
    """[S, S] bool: the (query, key) pairs the kernels let through."""
    qpos = torch.arange(s, device=device)[:, None]
    kpos = torch.arange(s, device=device)[None, :]
    mask = torch.ones((s, s), dtype=torch.bool, device=device)
    if causal:
        mask &= kpos <= qpos
    if window is not None:
        mask &= kpos > qpos - window
    return mask


def _scores(q, k, causal, window) -> torch.Tensor:
    """f32 scaled scores ``[B, H, S, S]`` over the GQA-repeated keys, the
    finite -1e30 outside the band."""
    b, h, s, d = q.shape
    k = k.repeat_interleave(h // k.shape[1], dim=1)
    scores = torch.einsum("bhqd,bhkd->bhqk", q.float(), k.float()) \
        / math.sqrt(d)
    # in place: at the serving shapes the scores are gigabytes
    return scores.masked_fill_(~_band(s, causal, window, q.device), -1e30)


def attention_lse_ref(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
                      causal: bool = True, window: Optional[int] = None
                      ) -> Tuple[torch.Tensor, torch.Tensor]:
    """``(o, lse)``: the attention of ``attention_ref`` and each row's f32
    log-sum-exp of its scaled, masked scores ``[B, H, S]`` (what the
    forward kernel writes for the backward)."""
    scores = _scores(q, k, causal, window)
    m = scores.amax(-1, keepdim=True)
    scores.sub_(m).exp_()
    total = scores.sum(-1, keepdim=True)
    scores.div_(total)
    v = v.repeat_interleave(q.shape[1] // v.shape[1], dim=1)
    out = torch.einsum("bhqk,bhkd->bhqd", scores, v.float())
    return out.to(q.dtype), (m + torch.log(total))[..., 0]


def attention_ref(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
                  causal: bool = True,
                  window: Optional[int] = None) -> torch.Tensor:
    """q: [B, H, S, D]; k/v: [B, K, S, D] (GQA repeat here).

    f32 math with the finite -1e30 mask, output in q's dtype."""
    return attention_lse_ref(q, k, v, causal=causal, window=window)[0]


def flash_attention_bwd_ref(q: torch.Tensor, k: torch.Tensor,
                            v: torch.Tensor, o: torch.Tensor,
                            lse: torch.Tensor, do: torch.Tensor, *,
                            causal: bool = True,
                            window: Optional[int] = None
                            ) -> Tuple[torch.Tensor, torch.Tensor,
                                       torch.Tensor]:
    """``(dq, dk, dv)`` of the attention from the forward's output ``o`` and
    ``lse``, the recompute the backward kernel does, in f32:
    ``P = exp(S - lse)``, ``delta = rowsum(dO * O)``, ``dV = P^T dO``,
    ``dS = P * (dO V^T - delta)``, ``dQ = scale * dS K``,
    ``dK = scale * dS^T Q``; ``dK`` and ``dV`` summed over the query heads
    of each kv head.  Results in the inputs' dtypes."""
    b, h, s, d = q.shape
    kv = k.shape[1]
    rep = h // kv
    scale = 1.0 / math.sqrt(d)
    p = _scores(q, k, causal, window).sub_(lse[..., None].float()).exp_()
    do32 = do.float()
    delta = (do32 * o.float()).sum(-1, keepdim=True)
    kr = k.repeat_interleave(rep, dim=1).float()
    vr = v.repeat_interleave(rep, dim=1).float()
    dv = torch.einsum("bhqk,bhqd->bhkd", p, do32)
    ds = torch.einsum("bhqd,bhkd->bhqk", do32, vr).sub_(delta).mul_(p)
    del p
    dq = torch.einsum("bhqk,bhkd->bhqd", ds, kr) * scale
    dk = torch.einsum("bhqk,bhqd->bhkd", ds, q.float()) * scale
    dk = dk.reshape(b, kv, rep, s, d).sum(2)
    dv = dv.reshape(b, kv, rep, s, d).sum(2)
    return dq.to(q.dtype), dk.to(k.dtype), dv.to(v.dtype)
