"""Distributed-optimization collectives beyond the paper, on the local mesh.

Counterpart of ``src/repro/comm/collectives.py``.  The reference calls these
inside ``shard_map`` on each rank's value; here a per-rank value is a
stacked tensor ``[R, ...]`` over a ``LocalMesh`` (``launch/mesh.py``), and
each function returns, per rank, what the reference returns.

* ``ef_compressed_psum``: int8 error-feedback gradient sum over one axis:
  quantize (grad + error carry) per tensor to int8, gather every group
  member's int8 payload and scale, dequantize and sum, and keep the
  quantization residual as the next step's carry.
* ``psum_bf16``: the sum over an axis in bf16.
* ``tree_ef_state``: the zero carry of a gradient dictionary.
"""

from __future__ import annotations

from typing import Dict, Optional, Tuple

import torch

from ..launch.mesh import LocalMesh, _group

__all__ = ["ef_compressed_psum", "psum_bf16", "tree_ef_state"]


def _quantize_int8(x: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """Per rank of ``x [R, ...]``: int8 values and the f32 scale ``[R]``."""
    flat = x.reshape(x.shape[0], -1)
    scale = torch.clamp(flat.abs().amax(-1), min=1e-30) / 127.0
    q = torch.clamp(torch.round(flat / scale[:, None]), -127, 127) \
        .to(torch.int8)
    return q.reshape(x.shape), scale


def ef_compressed_psum(mesh: LocalMesh, grad: torch.Tensor, axis_name: str,
                       error: Optional[torch.Tensor] = None
                       ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Error-feedback int8 gradient sum over ``axis_name`` of stacked
    ``grad [R, ...]``.  Returns (summed grad, new error), both stacked.
    The payload crossing the axis is int8 data plus one f32 scale per
    tensor."""
    carry = grad if error is None else grad + error
    q, scale = _quantize_int8(carry)
    members = mesh.cached_index(("a2a_members", (axis_name,)), grad.device,
                                lambda: _group(mesh, (axis_name,))[1])
    ones = (1,) * (grad.dim() - 1)
    total = None
    for j in range(members.shape[1]):     # the gathered members, in order
        src = members[:, j]
        deq = q.index_select(0, src).to(grad.dtype) \
            * scale.index_select(0, src).reshape(-1, *ones).to(grad.dtype)
        total = deq if total is None else total + deq
    new_error = carry - q.to(grad.dtype) \
        * scale.reshape(-1, *ones).to(grad.dtype)
    return total, new_error


def psum_bf16(mesh: LocalMesh, grad: torch.Tensor,
              axis_name: str) -> torch.Tensor:
    """The sum over ``axis_name`` of stacked ``grad [R, ...]`` in bf16 (half
    the bytes of f32), returned in ``grad``'s dtype on every rank."""
    dim = mesh.axis_names.index(axis_name)
    xm = grad.to(torch.bfloat16).reshape(*mesh.shape, *grad.shape[1:])
    total = xm.sum(dim=dim, keepdim=True, dtype=torch.bfloat16)
    return total.expand_as(xm).reshape(grad.shape).to(grad.dtype)


def tree_ef_state(grads: Dict[str, torch.Tensor]) -> Dict[str, torch.Tensor]:
    """Zero-initialized error-feedback carry matching a gradient dict."""
    return {k: torch.zeros_like(g) for k, g in grads.items()}
