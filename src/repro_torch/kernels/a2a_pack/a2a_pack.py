"""Destination-contiguous block packing for the plan-driven All-to-All.

Hopper counterpart of ``src/repro/kernels/a2a_pack/a2a_pack.py``
(``a2a_pack`` / ``a2a_unpack``, one Pallas builder ``_block_call``).  Both
wrappers launch the one CUDA kernel in ``csrc/a2a_block_copy.cu``: each CUDA
block reads its own index and copies a contiguous tile of one
``block_rows * D``-element block, in 16-byte vectors where the alignment
allows.  The work is pure data movement, so the bound is bytes read plus
bytes written over the HBM rate; the TPU kernel's 128-lane pad-and-slice and
8-row sublane tiling have no counterpart here.

A CPU tensor goes to the plain version in ``ref.py``; a CUDA tensor launches
the kernel or raises.  ``launches`` on each wrapper counts kernel launches.
"""

from __future__ import annotations

import ctypes

import torch

from ... import _build
from .ref import a2a_pack_ref, a2a_unpack_ref

__all__ = ["a2a_pack", "a2a_unpack"]


def _fn():
    fn = _build.load("a2a_block_copy").a2a_block_copy
    if fn.argtypes is None:  # 64-bit pointers need declared argtypes
        fn.argtypes = [ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p,
                       ctypes.c_longlong, ctypes.c_longlong,
                       ctypes.c_longlong, ctypes.c_int, ctypes.c_void_p]
        fn.restype = ctypes.c_int
    return fn


def _check(x: torch.Tensor, idx: torch.Tensor) -> None:
    """What the kernel takes, checked on every device so that a CPU run
    finds what the card would refuse."""
    if x.device.type not in ("cpu", "cuda"):
        raise ValueError(f"a2a kernels take CPU or CUDA tensors, not "
                         f"{x.device}")
    if x.dim() != 2 or idx.dim() != 1:
        raise ValueError(f"need x [N, D] and idx [M], got {tuple(x.shape)} "
                         f"and {tuple(idx.shape)}")
    if idx.device != x.device or idx.dtype != torch.int32:
        raise ValueError("idx must be int32 on the same device as x")
    if not (x.is_contiguous() and idx.is_contiguous()):
        raise ValueError("a2a kernels need contiguous x and idx")


def _block_copy(src: torch.Tensor, dst: torch.Tensor, idx: torch.Tensor,
               n_bound: int, block_bytes: int, scatter: bool) -> None:
    """Launch the block-copy kernel on the current stream.

    ``scatter=False``: dst block i <- src block idx[i];
    ``scatter=True``: dst block idx[i] <- src block i.  ``n_bound`` is the
    number of blocks on the indexed side; an index outside it traps.
    Does not count a launch: the public wrappers do.
    """
    fn = _fn()
    with torch.cuda.device(src.device):
        rc = fn(src.data_ptr(), dst.data_ptr(), idx.data_ptr(),
                idx.shape[0], n_bound, block_bytes, int(scatter),
                torch.cuda.current_stream(src.device).cuda_stream)
    if rc != 0:
        raise RuntimeError(f"a2a_block_copy launch failed: cudaError {rc}")


def a2a_pack(x: torch.Tensor, idx: torch.Tensor, *,
             block_rows: int = 1) -> torch.Tensor:
    """Gather ``block_rows``-row blocks of ``x [N, D]`` in ``idx`` order.

    Output block ``m`` is input block ``idx[m]``; returns
    ``[M * block_rows, D]``.
    """
    _check(x, idx)
    n, d = x.shape
    r = block_rows
    if r < 1 or n % r != 0:
        raise ValueError(f"block_rows={r} must divide N={n}")
    if x.device.type == "cpu":
        return a2a_pack_ref(x, idx, block_rows=r)
    out = torch.empty((idx.shape[0] * r, d), dtype=x.dtype, device=x.device)
    _block_copy(x, out, idx, n // r, r * d * x.element_size(), scatter=False)
    a2a_pack.launches += 1
    return out


def a2a_unpack(x: torch.Tensor, idx: torch.Tensor, *, n_out_blocks: int = 0,
               block_rows: int = 1) -> torch.Tensor:
    """Inverse scatter of ``a2a_pack``: output block ``idx[m]`` <- block
    ``m`` of ``x``.

    Returns ``[max(M, n_out_blocks) * block_rows, D]``.  Output blocks that
    ``idx`` does not name are unspecified (zero on the CPU path); duplicate
    indices are allowed only for a block the caller discards.
    """
    _check(x, idx)
    n, d = x.shape
    m = idx.shape[0]
    r = block_rows
    if r < 1 or n != m * r:
        raise ValueError(f"x rows {n} != M*block_rows = {m}*{r}")
    n_out = max(m, n_out_blocks)
    if x.device.type == "cpu":
        return a2a_unpack_ref(x, idx, n_out_blocks=n_out, block_rows=r)
    out = torch.empty((n_out * r, d), dtype=x.dtype, device=x.device)
    _block_copy(x, out, idx, n_out, r * d * x.element_size(), scatter=True)
    a2a_unpack.launches += 1
    return out


a2a_pack.launches = 0
a2a_unpack.launches = 0
