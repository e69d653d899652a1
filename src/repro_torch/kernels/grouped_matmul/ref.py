"""Plain PyTorch version of grouped_matmul (the kernel's oracle)."""

from __future__ import annotations

from typing import Optional

import torch

__all__ = ["grouped_matmul_ref"]


def grouped_matmul_ref(x: torch.Tensor, w: torch.Tensor,
                       counts: Optional[torch.Tensor] = None) -> torch.Tensor:
    """x: [E, C, D] @ w: [E, D, F] in f32 with per-expert row masking."""
    y = torch.einsum("ecd,edf->ecf", x.float(), w.float())
    if counts is not None:
        c = x.shape[1]
        valid = (torch.arange(c, device=x.device)[None, :, None]
                 < counts.to(x.device)[:, None, None])
        y = torch.where(valid, y, 0.0)
    return y.to(x.dtype)
