"""Grouped (per-expert) matmul for the MoE expert FFN.

Hopper counterpart of ``src/repro/kernels/grouped_matmul/grouped_matmul.py``
(``grouped_matmul``, Pallas body ``_gmm_kernel``): ``y[e] = x[e] @ w[e]`` with
f32 accumulation and rows ``>= counts[e]`` written as zero.  At the MoE
prefill shapes the product is bound by tensor-core operations, at decode by
reading the weights once.  ``csrc/grouped_matmul.cu`` holds three instances,
and ``variant`` picks one by dtype and shape alone:

* ``tma`` (bf16, ``D`` and ``F`` multiples of 8, 16-byte aligned bases): a
  persistent TMA + ``wgmma`` kernel, one producer warp feeding a 5-stage
  ring to two consumer warpgroups, tiles walked so that the row tiles of a
  weight tile run together.  Every serving shape takes it.
* ``wmma`` (bf16, any other shape; TMA needs 16-byte row strides): WMMA
  tiles with synchronous loads.
* ``simt`` (f32): plain f32 FMAs, no TF32.

Every instance skips the K loop of a row tile wholly past ``counts[e]``.
A CPU tensor goes to the plain version in ``ref.py``; a CUDA tensor launches
the kernel or raises; a meta tensor, taken only while
``launch/roofline.count()`` is active (the dry run), gets an empty output of
the right shape.  Each call reports its cost to ``launch/roofline.count()``
(``gmm_cost``: 2·E·C·D·F operations, padded rows included), and nothing run
inside it is counted.  ``grouped_matmul.launches`` counts kernel launches,
``grouped_matmul.launches_by_variant`` the same by instance.

``transpose_x`` / ``transpose_w`` multiply by ``x^T`` / ``w^T`` of the
stored tensors.  The ``tma`` instance reads such an operand in place (the
other operand layout of its TMA boxes and ``wgmma``'s transpose bits); the
other instances take a contiguous copy of the transpose, chosen by the same
rule, never as a fallback.

``grouped_matmul_autograd`` is the differentiable form, on both devices:
its backward is two more calls of ``grouped_matmul`` (so two launches on
the card), with ``dY_m`` = ``dY`` whose rows at or past ``counts[e]`` are
zero (the forward wrote those rows as a constant):

* ``dX = grouped_matmul(dY_m, W, counts, transpose_w=True)``
  (``[E, C, F] @ W^T [E, F, D]``),
* ``dW = grouped_matmul(X, dY_m, transpose_x=True)``
  (``X^T [E, D, C] @ [E, C, F]``).

At the training shapes every dimension is a multiple of 8, so both take the
TMA + ``wgmma`` instance and copy nothing.
"""

from __future__ import annotations

import ctypes
from typing import Optional

import torch

from ... import _build
from ...launch.roofline import counted as _counted
from ...launch.roofline import devices, gmm_cost
from .ref import grouped_matmul_ref

__all__ = ["grouped_matmul", "grouped_matmul_autograd", "variant"]

_DTYPES = (torch.float32, torch.bfloat16)
_VARIANTS = {"simt": 0, "wmma": 1, "tma": 2}
_INT_MAX = 2 ** 31 - 1


def variant(dtype: torch.dtype, d: int, f: int, aligned: bool = True,
            c: int = 0) -> str:
    """The kernel instance for ``[E, c, d] @ [E, d, f]``: ``"simt"`` for
    f32; for bf16 ``"tma"`` when TMA can address the rows (``d`` and ``f``
    multiples of 8, so that row strides are multiples of 16 bytes, ``d > 0``,
    ``c`` a multiple of 8 too, which matters only when x is stored
    transposed (pass 0 otherwise), and ``aligned``: the bases of x, w and y
    on 16 bytes), else ``"wmma"``."""
    if dtype == torch.float32:
        return "simt"
    if d > 0 and d % 8 == 0 and f % 8 == 0 and c % 8 == 0 and aligned:
        return "tma"
    return "wmma"


def _fn():
    fn = _build.load("grouped_matmul").grouped_matmul
    if fn.argtypes is None:  # 64-bit pointers need declared argtypes
        fn.argtypes = [ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p,
                       ctypes.c_void_p, ctypes.c_int, ctypes.c_int,
                       ctypes.c_int, ctypes.c_int, ctypes.c_int,
                       ctypes.c_int, ctypes.c_void_p]
        fn.restype = ctypes.c_int
    return fn


def grouped_matmul(x: torch.Tensor, w: torch.Tensor,
                   counts: Optional[torch.Tensor] = None, *,
                   transpose_x: bool = False,
                   transpose_w: bool = False) -> torch.Tensor:
    """``x [E, C, D] @ w [E, D, F] -> [E, C, F]`` in ``x``'s dtype.

    ``counts [E]`` (int32) gives each expert's valid rows; rows at or past
    it are zero.  ``None`` means every row is valid.  ``transpose_x``: ``x``
    is stored as ``[E, D, C]`` and multiplies as its transpose;
    ``transpose_w``: ``w`` is stored as ``[E, F, D]``.
    """
    if x.dim() != 3 or w.dim() != 3:
        raise ValueError(f"need x [E, C, D] and w [E, D, F], got "
                         f"{tuple(x.shape)} and {tuple(w.shape)}")
    xs, ws = x.transpose(1, 2) if transpose_x else x, \
        w.transpose(1, 2) if transpose_w else w
    e, c, d = xs.shape
    f = ws.shape[-1]
    if tuple(ws.shape) != (e, d, f):
        raise ValueError(f"w {tuple(ws.shape)} does not match x "
                         f"{tuple(xs.shape)}")
    if counts is not None and tuple(counts.shape) != (e,):
        raise ValueError(f"counts must be [{e}], got {tuple(counts.shape)}")
    # checked on every device, so that a CPU run finds what the card refuses
    if x.device.type not in devices() or w.device != x.device:
        raise ValueError(f"grouped_matmul takes CPU or CUDA tensors (and "
                         f"meta ones while counting) on one device, got "
                         f"{x.device} and {w.device}")
    if x.dtype not in _DTYPES or w.dtype != x.dtype:
        raise ValueError(f"grouped_matmul takes f32 or bf16 x and w of one "
                         f"dtype, got {x.dtype} and {w.dtype}")
    if not (x.is_contiguous() and w.is_contiguous()):
        raise ValueError("grouped_matmul needs contiguous x and w")
    if max(e, c, d, f) > _INT_MAX:
        raise ValueError("grouped_matmul dimensions must fit in int32")
    if counts is not None and (counts.dtype != torch.int32
                               or counts.device != x.device
                               or not counts.is_contiguous()):
        raise ValueError("counts must be contiguous int32 on x's device")
    with _counted("grouped_matmul", gmm_cost(e, c, d, f, x.element_size())):
        if x.device.type == "cpu":
            return grouped_matmul_ref(xs, ws, counts)
        y = torch.empty((e, c, f), dtype=x.dtype, device=x.device)
        if x.device.type == "meta":
            return y
        name = variant(x.dtype, d, f, all(t.data_ptr() % 16 == 0
                                          for t in (x, w, y)),
                       c if transpose_x else 0)
        if name != "tma" and (transpose_x or transpose_w):
            # only the TMA instance reads a transposed operand in place
            x, w = xs.contiguous(), ws.contiguous()
            transpose_x = transpose_w = False
            name = variant(x.dtype, d, f, all(t.data_ptr() % 16 == 0
                                              for t in (x, w, y)))
        rc = _build.launch(_fn(), x.device, x.data_ptr(), w.data_ptr(),
                           y.data_ptr(),
                           None if counts is None else counts.data_ptr(),
                           e, c, d, f, _VARIANTS[name],
                           int(transpose_x) | 2 * int(transpose_w))
    if rc != 0:
        raise RuntimeError(f"grouped_matmul ({name}) launch failed: "
                           f"cudaError {rc}")
    grouped_matmul.launches += 1
    grouped_matmul.launches_by_variant[name] += 1
    return y


grouped_matmul.launches = 0
grouped_matmul.launches_by_variant = dict.fromkeys(_VARIANTS, 0)


def _rows_mask(dy: torch.Tensor, counts: Optional[torch.Tensor]
               ) -> torch.Tensor:
    """``dy`` contiguous, with rows at or past ``counts[e]`` zero."""
    if counts is None:
        return dy.contiguous()
    valid = (torch.arange(dy.shape[1], device=dy.device)[None, :, None]
             < counts[:, None, None])
    return torch.where(valid, dy, 0).contiguous()


class _GroupedMatmul(torch.autograd.Function):
    """``grouped_matmul`` with its backward on the same kernel."""

    @staticmethod
    def forward(ctx, x, w, counts):
        ctx.save_for_backward(x, w, counts)
        return grouped_matmul(x, w, counts)

    @staticmethod
    def backward(ctx, dy):
        x, w, counts = ctx.saved_tensors
        dy_m = _rows_mask(dy, counts)
        dx = dw = None
        if ctx.needs_input_grad[0]:
            dx = grouped_matmul(dy_m, w, counts, transpose_w=True)
        if ctx.needs_input_grad[1]:
            dw = grouped_matmul(x, dy_m, transpose_x=True)
        return dx, dw, None


def grouped_matmul_autograd(x: torch.Tensor, w: torch.Tensor,
                            counts: Optional[torch.Tensor] = None
                            ) -> torch.Tensor:
    """``grouped_matmul`` that autograd differentiates through the kernel
    (on the CPU, through the plain version's same products).  Without a
    gradient to take it is ``grouped_matmul`` itself."""
    if torch.is_grad_enabled() and (x.requires_grad or w.requires_grad):
        return _GroupedMatmul.apply(x, w, counts)
    return grouped_matmul(x, w, counts)
