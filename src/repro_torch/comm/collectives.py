"""Distributed-optimization collectives beyond the paper, on either mesh.

Counterpart of ``src/repro/comm/collectives.py``.  The reference calls these
inside ``shard_map`` on each rank's value; here a per-rank value is a
stacked tensor ``[R, ...]`` over a ``LocalMesh`` or, with ``R = 1``, a
``ProcessMesh`` (``launch/mesh.py``), and each function returns, per rank,
what the reference returns.  Each gathers every group member's payload
(``launch/mesh.all_gather``, an index copy on a ``LocalMesh`` and the axis's
process group on a ``ProcessMesh``) and sums it in member order, so the two
meshes agree bit for bit.

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

from ..launch.mesh import all_gather, member_sum

__all__ = ["ef_compressed_psum", "psum_bf16", "tree_ef_state"]


def _quantize_int8(x: torch.Tensor, amax: Optional[torch.Tensor] = None
                   ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Per rank of ``x [R, ...]``: int8 values and the f32 scale ``[R]``
    (from ``amax [R]``, each rank's largest magnitude, when ``x`` is a slice
    of the tensor the scale is of)."""
    flat = x.reshape(x.shape[0], -1)
    if amax is None:
        amax = flat.abs().amax(-1)
    scale = torch.clamp(amax, min=1e-30) / 127.0
    q = torch.clamp(torch.round(flat / scale[:, None]), -127, 127) \
        .to(torch.int8)
    return q.reshape(x.shape), scale


def ef_compressed_psum(mesh, grad: torch.Tensor, axis_name: str,
                       error: Optional[torch.Tensor] = None
                       ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Error-feedback int8 gradient sum over ``axis_name`` of stacked
    ``grad [R, ...]``.  Returns (summed grad, new error), both stacked.
    The payload crossing the axis is int8 data plus one f32 scale per
    tensor."""
    carry = grad if error is None else grad + error
    q, scale = _quantize_int8(carry)
    ones = (1,) * (grad.dim() - 1)
    qs = all_gather(mesh, q, axis_name)            # [R, n, ...]
    scales = all_gather(mesh, scale, axis_name)    # [R, n]
    total = member_sum(qs[:, j].to(grad.dtype)
                       * scales[:, j].reshape(-1, *ones).to(grad.dtype)
                       for j in range(qs.shape[1]))
    new_error = carry - q.to(grad.dtype) \
        * scale.reshape(-1, *ones).to(grad.dtype)
    return total, new_error


def psum_bf16(mesh, grad: torch.Tensor, axis_name: str) -> torch.Tensor:
    """The sum over ``axis_name`` of stacked ``grad [R, ...]`` in bf16 (half
    the bytes of f32), returned in ``grad``'s dtype on every rank."""
    parts = all_gather(mesh, grad.to(torch.bfloat16), axis_name)
    return parts.sum(dim=1, dtype=torch.bfloat16).to(grad.dtype)


def tree_ef_state(grads: Dict[str, torch.Tensor]) -> Dict[str, torch.Tensor]:
    """Zero-initialized error-feedback carry matching a gradient dict."""
    return {k: torch.zeros_like(g) for k, g in grads.items()}
