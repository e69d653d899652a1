"""Plain PyTorch versions of a2a_pack / a2a_unpack (the kernels' oracles)."""

from __future__ import annotations

import torch

__all__ = ["a2a_pack_ref", "a2a_unpack_ref"]


def a2a_pack_ref(x: torch.Tensor, idx: torch.Tensor,
                 block_rows: int = 1) -> torch.Tensor:
    """out block m = x block idx[m] (block_rows=1: out[m] = x[idx[m]])."""
    n, d = x.shape
    blocks = x.reshape(n // block_rows, block_rows, d)
    return blocks.index_select(0, idx.long()).reshape(-1, d)


def a2a_unpack_ref(x: torch.Tensor, idx: torch.Tensor, n_out_blocks: int = 0,
                   block_rows: int = 1) -> torch.Tensor:
    """out block idx[m] = x block m; unnamed output blocks are zero."""
    m = idx.shape[0]
    d = x.shape[-1]
    n_out = max(m, n_out_blocks)
    out = torch.zeros((n_out, block_rows, d), dtype=x.dtype, device=x.device)
    out.index_copy_(0, idx.long(), x.reshape(m, block_rows, d))
    return out.reshape(-1, d)
