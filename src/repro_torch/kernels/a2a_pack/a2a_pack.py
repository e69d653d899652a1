"""Destination-contiguous block packing for the plan-driven All-to-All.

Hopper counterpart of ``src/repro/kernels/a2a_pack/a2a_pack.py``
(``a2a_pack`` / ``a2a_unpack``, one Pallas builder ``_block_call``).  Both
wrappers launch the one CUDA kernel source ``csrc/a2a_block_copy.cu``, whose
instance ``variant`` picks from the block size, the block count and the two
pointers alone:

* ``bulk`` (block bytes a multiple of 16, both pointers 16-byte aligned, at
  least ``BULK_MIN_BYTES`` moved): a persistent grid of at most one CTA per
  SM, each copying its run of (block, chunk) items through a ring of shared
  memory with Hopper's bulk asynchronous copies (``cp.async.bulk``), the
  next block's index read ahead.  Mixtral's prefill exchanges take it.
* ``vec`` (aligned as ``bulk``, fewer bytes): a CTA per (block, tile), four
  16-byte vectors a thread.  On an H100 it beats ``bulk`` by 20 to 30% where
  the copy fits in the L2 (every decode exchange) and by 1 to 3% at
  megatron's prefill (``PERF.md``).
* ``bytes`` (any other block): the same grid, one byte a thread.

The work is pure data movement, so the bound is bytes read plus bytes
written over the HBM rate; the TPU kernel's 128-lane pad-and-slice and
8-row sublane tiling have no counterpart here.

A CPU tensor goes to the plain version in ``ref.py``; a CUDA tensor launches
the chosen instance or raises; a meta tensor, taken only while
``launch/roofline.count()`` is active (the dry run), gets an empty output of
the right shape.  Each call reports its bytes to ``launch/roofline.count()``
(``copy_cost``: the moved blocks read and written once), and nothing run
inside it is counted.  ``launches`` on each wrapper counts kernel
launches, ``launches_by_variant`` the same by instance.

Neither wrapper has a gradient, on either device: under autograd (an input
that requires grad, grad mode on) the result's backward raises
``NotImplementedError``, as ``jax.grad`` through the reference's Pallas pack
raises (``pallas_call`` has no transpose rule).  Without this the kernel's
output would silently cut the graph.
"""

from __future__ import annotations

import ctypes
from typing import Optional

import torch

from ... import _build
from ...launch.roofline import copy_cost, devices
from ...launch.roofline import counted as _counted
from .ref import a2a_pack_ref, a2a_unpack_ref

__all__ = ["a2a_pack", "a2a_unpack", "variant", "BULK_MIN_BYTES"]

_VARIANTS = {"bytes": 0, "bulk": 1, "vec": 2}
# bytes moved from which the bulk copies are at least as fast as vec
BULK_MIN_BYTES = 512 << 20


def variant(block_bytes: int, n_blocks: int, src_ptr: int,
            dst_ptr: int) -> str:
    """The kernel instance for ``n_blocks`` blocks of ``block_bytes`` bytes
    copied from address ``src_ptr`` to ``dst_ptr``: ``"bytes"`` unless the
    16-byte paths can address them (``block_bytes`` a multiple of 16, both
    pointers on 16 bytes); then ``"bulk"`` from ``BULK_MIN_BYTES`` moved,
    ``"vec"`` below."""
    if block_bytes % 16 or src_ptr % 16 or dst_ptr % 16:
        return "bytes"
    return "bulk" if n_blocks * block_bytes >= BULK_MIN_BYTES else "vec"


def _fn():
    fn = _build.load("a2a_block_copy").a2a_block_copy
    if fn.argtypes is None:  # 64-bit pointers need declared argtypes
        fn.argtypes = [ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p,
                       ctypes.c_longlong, ctypes.c_longlong,
                       ctypes.c_longlong, ctypes.c_int, ctypes.c_int,
                       ctypes.c_void_p]
        fn.restype = ctypes.c_int
    return fn


def _check(x: torch.Tensor, idx: torch.Tensor) -> None:
    """What the kernel takes, checked on every device so that a CPU run
    finds what the card would refuse."""
    if x.device.type not in devices():
        raise ValueError(f"a2a kernels take CPU or CUDA tensors (and meta "
                         f"ones while counting), not {x.device}")
    if x.dim() != 2 or idx.dim() != 1:
        raise ValueError(f"need x [N, D] and idx [M], got {tuple(x.shape)} "
                         f"and {tuple(idx.shape)}")
    if idx.device != x.device or idx.dtype != torch.int32:
        raise ValueError("idx must be int32 on the same device as x")
    if not (x.is_contiguous() and idx.is_contiguous()):
        raise ValueError("a2a kernels need contiguous x and idx")


def _block_copy(src: torch.Tensor, dst: torch.Tensor, idx: torch.Tensor,
                n_bound: int, block_bytes: int, scatter: bool,
                name: Optional[str] = None) -> str:
    """Launch the block-copy kernel on the current stream and return the
    instance launched: ``name``, or ``variant``'s choice.

    ``scatter=False``: dst block i <- src block idx[i];
    ``scatter=True``: dst block idx[i] <- src block i.  ``n_bound`` is the
    number of blocks on the indexed side; an index outside it traps.
    Does not count a launch: the public wrappers do.
    """
    fn = _fn()
    src_ptr, dst_ptr = src.data_ptr(), dst.data_ptr()
    name = name or variant(block_bytes, idx.shape[0], src_ptr, dst_ptr)
    rc = _build.launch(fn, src.device, src_ptr, dst_ptr, idx.data_ptr(),
                       idx.shape[0], n_bound, block_bytes, int(scatter),
                       _VARIANTS[name])
    if rc != 0:
        raise RuntimeError(f"a2a_block_copy ({name}) launch failed: "
                           f"cudaError {rc}")
    return name


_NO_GRADIENT = (
    "{} has no gradient: the reference's Pallas pack has none either "
    "(pallas_call has no transpose rule, so jax.grad through "
    "impl='plan' raises).  Train through the 'flash' exchange, or with "
    "use_kernel=False; ROADMAP.md Queue 3 (a gradient through the plan "
    "exchange) holds the missing piece.")


class _NoGradient(torch.autograd.Function):
    """Runs ``fn(x)`` and raises in the backward instead of returning a
    detached result."""

    @staticmethod
    def forward(ctx, x, fn, name):
        ctx.name = name
        return fn(x)

    @staticmethod
    def backward(ctx, grad):
        raise NotImplementedError(_NO_GRADIENT.format(ctx.name))


def _guarded(x: torch.Tensor, fn, name: str) -> torch.Tensor:
    if torch.is_grad_enabled() and x.requires_grad:
        return _NoGradient.apply(x, fn, name)
    return fn(x)


def a2a_pack(x: torch.Tensor, idx: torch.Tensor, *,
             block_rows: int = 1) -> torch.Tensor:
    """Gather ``block_rows``-row blocks of ``x [N, D]`` in ``idx`` order.

    Output block ``m`` is input block ``idx[m]``; returns
    ``[M * block_rows, D]``.
    """
    return _guarded(x, lambda t: _pack(t, idx, block_rows), "a2a_pack")


def _pack(x: torch.Tensor, idx: torch.Tensor, block_rows: int
          ) -> torch.Tensor:
    _check(x, idx)
    n, d = x.shape
    r = block_rows
    if r < 1 or n % r != 0:
        raise ValueError(f"block_rows={r} must divide N={n}")
    with _counted("a2a_pack",
                  copy_cost(idx.shape[0] * r * d * x.element_size())):
        if x.device.type == "cpu":
            return a2a_pack_ref(x, idx, block_rows=r)
        out = torch.empty((idx.shape[0] * r, d), dtype=x.dtype,
                          device=x.device)
        if x.device.type == "meta":
            return out
        name = _block_copy(x, out, idx, n // r, r * d * x.element_size(),
                           scatter=False)
    a2a_pack.launches += 1
    a2a_pack.launches_by_variant[name] += 1
    return out


def a2a_unpack(x: torch.Tensor, idx: torch.Tensor, *, n_out_blocks: int = 0,
               block_rows: int = 1) -> torch.Tensor:
    """Inverse scatter of ``a2a_pack``: output block ``idx[m]`` <- block
    ``m`` of ``x``.

    Returns ``[max(M, n_out_blocks) * block_rows, D]``.  Output blocks that
    ``idx`` does not name are unspecified (zero on the CPU path); duplicate
    indices are allowed only for a block the caller discards.
    """
    return _guarded(x, lambda t: _unpack(t, idx, n_out_blocks, block_rows),
                    "a2a_unpack")


def _unpack(x: torch.Tensor, idx: torch.Tensor, n_out_blocks: int,
            block_rows: int) -> torch.Tensor:
    _check(x, idx)
    n, d = x.shape
    m = idx.shape[0]
    r = block_rows
    if r < 1 or n != m * r:
        raise ValueError(f"x rows {n} != M*block_rows = {m}*{r}")
    n_out = max(m, n_out_blocks)
    with _counted("a2a_unpack", copy_cost(n * d * x.element_size())):
        if x.device.type == "cpu":
            return a2a_unpack_ref(x, idx, n_out_blocks=n_out, block_rows=r)
        out = torch.empty((n_out * r, d), dtype=x.dtype, device=x.device)
        if x.device.type == "meta":
            return out
        name = _block_copy(x, out, idx, n_out, r * d * x.element_size(),
                           scatter=True)
    a2a_unpack.launches += 1
    a2a_unpack.launches_by_variant[name] += 1
    return out


a2a_pack.launches = 0
a2a_unpack.launches = 0
a2a_pack.launches_by_variant = dict.fromkeys(_VARIANTS, 0)
a2a_unpack.launches_by_variant = dict.fromkeys(_VARIANTS, 0)
