"""Blockwise (flash) attention with GQA, causal masking and a sliding window.

Hopper counterpart of ``src/repro/kernels/flash_attention/flash_attention.py``
(``flash_attention``, Pallas body ``_flash_kernel``): forward-only online
softmax attention on ``q [B, H, S, D]`` and ``k``/``v [B, K, S, D]``, the kv
head of query head ``h`` being ``h // (H / K)``, masked with the finite
``-1e30``, output ``acc / max(l, 1e-30)`` in q's dtype.  The CUDA kernel is
``csrc/flash_attention.cu``: one block per (q tile, batch * head) loops
over exactly the kv tiles that meet the causal band and the window.  In
bf16 (128-row q tiles) it keeps S, P and O in registers (``mma.sync``
m16n8k16, P as hi + lo bf16 terms) and streams k and v through double
``cp.async`` buffers; in f32 (64-row q tiles) it runs plain f32 FMAs (no
TF32).  It takes any ``S >= 1`` (the TPU kernel
needs ``S`` to divide its blocks) and any head dim up to 128.  It is bound
by the operations, 4 * D per visible (q, k) pair and head.

The kernel reads q, k and v through their strides, so ``[B, S, H, D]``
projections pass as ``.transpose(1, 2)`` views without a copy; it writes
``[B, S, H, D]`` memory, and the result is its ``[B, H, S, D]`` view (the
plain version's result is laid out the same way), so ``.transpose(1, 2)``
of it is contiguous.

With ``return_lse`` the kernel also writes each row's log-sum-exp of its
scaled, masked scores, ``lse [B, H, S]`` in f32, which the backward needs;
serving asks for none and its kernel skips the store.

The backward is its own hand-written kernel, ``csrc/flash_attention_bwd.cu``
(``flash_attention_bwd``): the reference has no backward kernel (it takes
the gradient of its einsum attention), so nothing on the TPU side is
replaced there.  It is deterministic (two passes, dK/dV and dQ, each output
written by one block, no atomics) and holds two instances, which
``variant`` picks by dtype, head dim and alignment alone:

* ``wgmma`` (bf16, the head dim a multiple of 8, and rows TMA can address:
  every base of q, k, v, o and dO on 16 bytes and every batch, head and
  sequence stride a nonzero multiple of 16 bytes): TMA loads through a
  ring, a producer warp and two consumer warpgroups on ``wgmma``, P and dS
  as bf16 register operands.  The training shapes take it, as
  ``[B, S, H, D]`` views.
* ``simt`` (f32, an odd head dim, unaligned views): plain f32 FMAs.

``flash_attention_autograd`` ties the forward and the backward together for
autograd, on both devices.

A CPU tensor goes to the plain versions in ``ref.py``; a CUDA tensor
launches the kernel or raises; meta tensors, taken only while
``launch/roofline.count()`` is active (the dry run), get empty outputs of the
right shapes.  Each call reports its cost to ``launch/roofline.count()``
(``attn_cost``, ``attn_bwd_cost``: 4·D and 10·D operations per visible pair
and head), and nothing run inside it is counted.
``flash_attention.launches`` and
``flash_attention_bwd.launches`` count kernel launches,
``flash_attention_bwd.launches_by_variant`` the latter by instance.
"""

from __future__ import annotations

import ctypes
from typing import Optional

import torch

from ... import _build
from ...launch.roofline import attn_bwd_cost, attn_cost, devices
from ...launch.roofline import counted as _counted
from .ref import attention_lse_ref, flash_attention_bwd_ref

__all__ = ["flash_attention", "flash_attention_bwd",
           "flash_attention_autograd", "rows_aligned", "variant"]

_DTYPES = {torch.float32: 0, torch.bfloat16: 1}
_VARIANTS = {"simt": 0, "wgmma": 1}
_MAX_HEAD_DIM = 128
_INT_MAX = 2 ** 31 - 1


def _fn():
    fn = _build.load("flash_attention").flash_attention
    if fn.argtypes is None:  # 64-bit pointers need declared argtypes
        fn.argtypes = [ctypes.c_void_p] * 5 + [ctypes.c_int] * 7 + [
            ctypes.c_float, ctypes.c_int, ctypes.c_void_p, ctypes.c_void_p]
        fn.restype = ctypes.c_int
    return fn


def _bshd_output(q: torch.Tensor) -> torch.Tensor:
    """An empty ``[B, H, S, D]`` view of ``[B, S, H, D]`` memory."""
    b, h, s, d = q.shape
    return torch.empty((b, s, h, d), dtype=q.dtype,
                       device=q.device).transpose(1, 2)


def _check(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
           window: Optional[int]) -> None:
    """What the kernels take, checked on every device so that a CPU run
    finds what the card refuses."""
    if q.dim() != 4 or k.dim() != 4 or v.dim() != 4:
        raise ValueError(f"need q [B, H, S, D] and k, v [B, K, S, D], got "
                         f"{tuple(q.shape)}, {tuple(k.shape)}, "
                         f"{tuple(v.shape)}")
    b, h, s, d = q.shape
    kv = k.shape[1]
    if tuple(k.shape) != (b, kv, s, d) or v.shape != k.shape:
        raise ValueError(f"k {tuple(k.shape)} and v {tuple(v.shape)} do not "
                         f"match q {tuple(q.shape)}")
    if kv < 1 or h % kv:
        raise ValueError(f"GQA needs H % K == 0, got H={h}, K={kv}")
    if q.device.type not in devices() or not (
            k.device == q.device and v.device == q.device):
        raise ValueError(f"flash_attention takes CPU or CUDA tensors (and "
                         f"meta ones while counting) on one device, got "
                         f"{q.device}, {k.device}, {v.device}")
    if q.dtype not in _DTYPES or not (k.dtype == q.dtype
                                      and v.dtype == q.dtype):
        raise ValueError(f"flash_attention takes f32 or bf16 q, k, v of one "
                         f"dtype, got {q.dtype}, {k.dtype}, {v.dtype}")
    if not 1 <= d <= _MAX_HEAD_DIM:
        raise ValueError(f"flash_attention takes head dims 1 to "
                         f"{_MAX_HEAD_DIM}, got {d}")
    if any(t.stride(-1) != 1 and d > 1 for t in (q, k, v)):
        raise ValueError(f"flash_attention needs a unit stride in the head "
                         f"dim, got {q.stride()}, {k.stride()}, "
                         f"{v.stride()}")
    if window is not None and not 1 <= window <= _INT_MAX:
        raise ValueError(f"window must be None or in [1, 2**31), got "
                         f"{window}")
    if max(b * h * s, s * d) > _INT_MAX:
        raise ValueError("flash_attention dimensions must fit in int32")


def _strides(*ts: torch.Tensor):
    return (ctypes.c_longlong * (3 * len(ts)))(*(
        st for t in ts for st in t.stride()[:3]))


def flash_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
                    causal: bool = True, window: Optional[int] = None,
                    return_lse: bool = False):
    """Attention of ``q [B, H, S, D]`` over ``k``/``v [B, K, S, D]``.

    ``causal`` keeps keys at or before each query; ``window`` (None or
    >= 1) keeps the ``window`` keys ending at the query's position.
    Any strides are taken as long as the head dim's is 1.  Returns
    ``[B, H, S, D]`` in q's dtype, a view of ``[B, S, H, D]`` memory, and
    with ``return_lse`` also ``lse [B, H, S]`` (f32).
    """
    _check(q, k, v, window)
    b, h, s, d = q.shape
    with _counted("flash_attention", attn_cost(
            b, h, k.shape[1], s, d, causal, window, q.element_size())):
        o = _bshd_output(q)
        if q.device.type == "cpu":
            out, lse = attention_lse_ref(q, k, v, causal=causal,
                                         window=window)
            o.copy_(out)
            return (o, lse) if return_lse else o
        lse = torch.empty((b, h, s), dtype=torch.float32, device=q.device) \
            if return_lse else None
        if q.device.type == "meta":
            return (o, lse) if return_lse else o
        rc = _build.launch(_fn(), q.device, q.data_ptr(), k.data_ptr(),
                           v.data_ptr(), o.data_ptr(), _strides(q, k, v, o),
                           b, h, k.shape[1], s, d, int(causal),
                           -1 if window is None else int(window),
                           1.0 / d ** 0.5, _DTYPES[q.dtype],
                           None if lse is None else lse.data_ptr())
    if rc != 0:
        raise RuntimeError(f"flash_attention launch failed: cudaError {rc}")
    flash_attention.launches += 1
    return (o, lse) if return_lse else o


def variant(dtype: torch.dtype, d: int, aligned: bool = True) -> str:
    """The backward's kernel instance: ``"wgmma"`` for bf16 with a head
    dim ``d`` that is a multiple of 8 (up to 128) and ``aligned`` rows (see
    ``rows_aligned``), else ``"simt"``."""
    if dtype == torch.bfloat16 and d % 8 == 0 and 8 <= d <= _MAX_HEAD_DIM \
            and aligned:
        return "wgmma"
    return "simt"


def rows_aligned(*ts: torch.Tensor) -> bool:
    """Every base on 16 bytes and every batch, head and sequence stride of
    a dimension wider than 1 a nonzero multiple of 16 bytes: rows that TMA
    can address."""
    for t in ts:
        if t.data_ptr() % 16:
            return False
        for n, st in zip(t.shape[:3], t.stride()[:3]):
            if n > 1 and (st == 0 or st * t.element_size() % 16):
                return False
    return True


def _bwd_fn():
    fn = _build.load("flash_attention_bwd").flash_attention_bwd
    if fn.argtypes is None:  # 64-bit pointers need declared argtypes
        fn.argtypes = [ctypes.c_void_p] * 11 + [ctypes.c_int] * 7 + [
            ctypes.c_float, ctypes.c_int, ctypes.c_int, ctypes.c_void_p]
        fn.restype = ctypes.c_int
    return fn


def _bwd_inputs(q, k, v, o, lse, do, window):
    """Checks the backward's inputs on every device; returns ``o``, ``do``
    with a unit head stride and ``lse`` contiguous."""
    _check(q, k, v, window)
    b, h, s, d = q.shape
    if tuple(o.shape) != (b, h, s, d) or do.shape != o.shape \
            or tuple(lse.shape) != (b, h, s):
        raise ValueError(f"o {tuple(o.shape)}, do {tuple(do.shape)} and lse "
                         f"{tuple(lse.shape)} do not match q "
                         f"{tuple(q.shape)}")
    if o.dtype != q.dtype or do.dtype != q.dtype \
            or lse.dtype != torch.float32:
        raise ValueError("o and do must have q's dtype and lse float32")
    if do.stride(-1) != 1 and d > 1:
        do = do.contiguous()
    if o.stride(-1) != 1 and d > 1:
        o = o.contiguous()
    return o, do, lse.contiguous()


def _bwd_call(q, k, v, o, lse, do, causal, window, name):
    """One launch of instance ``name`` on CUDA inputs that ``_bwd_inputs``
    passed, uncounted; ``(dq, dk, dv)``."""
    b, h, s, d = q.shape
    dq = _bshd_output(q)
    dk, dv = _bshd_output(k), _bshd_output(v)
    if name == "wgmma":   # lse * log2(e) and delta, rows padded to 128
        shape = (2, b * h, -(-s // 128) * 128)
    else:
        shape = (b, h, s)
    scratch = torch.empty(shape, dtype=torch.float32, device=q.device)
    rc = _build.launch(_bwd_fn(), q.device, q.data_ptr(), k.data_ptr(),
                       v.data_ptr(), o.data_ptr(), do.data_ptr(),
                       lse.data_ptr(), scratch.data_ptr(), dq.data_ptr(),
                       dk.data_ptr(), dv.data_ptr(),
                       _strides(q, k, v, o, do, dq, dk, dv), b, h,
                       k.shape[1], s, d, int(causal),
                       -1 if window is None else int(window), 1.0 / d ** 0.5,
                       _DTYPES[q.dtype], _VARIANTS[name])
    if rc != 0:
        raise RuntimeError(f"flash_attention_bwd ({name}) launch failed: "
                           f"cudaError {rc}")
    return dq, dk, dv


def flash_attention_bwd(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                        o: torch.Tensor, lse: torch.Tensor, do: torch.Tensor,
                        *, causal: bool = True, window: Optional[int] = None):
    """``(dq, dk, dv)`` of ``flash_attention`` from its output ``o`` and
    ``lse`` and the output's gradient ``do`` (``o``'s shape, any strides
    with a unit head dim).  Returns ``dq [B, H, S, D]`` and ``dk``, ``dv
    [B, K, S, D]`` in the inputs' dtype, each a view of ``[B, S, ., D]``
    memory (the layout of the projections they flow back into).  On the
    card the instance is ``variant``'s for these inputs."""
    b, h, s, d = q.shape
    with _counted("flash_attention_bwd", attn_bwd_cost(
            b, h, k.shape[1], s, d, causal, window, q.element_size())):
        o, do, lse = _bwd_inputs(q, k, v, o, lse, do, window)
        grads = _bshd_output(q), _bshd_output(k), _bshd_output(v)
        if q.device.type == "cpu":
            # in the kernel's layout, as the forward's output
            for g, ref in zip(grads, flash_attention_bwd_ref(
                    q, k, v, o, lse, do, causal=causal, window=window)):
                g.copy_(ref)
            return grads
        if q.device.type == "meta":
            return grads
        name = variant(q.dtype, q.shape[-1], rows_aligned(q, k, v, o, do))
        out = _bwd_call(q, k, v, o, lse, do, causal, window, name)
    flash_attention_bwd.launches += 1
    flash_attention_bwd.launches_by_variant[name] += 1
    return out


flash_attention.launches = 0
flash_attention_bwd.launches = 0
flash_attention_bwd.launches_by_variant = dict.fromkeys(_VARIANTS, 0)


class _FlashAttention(torch.autograd.Function):
    """The forward kernel (with ``lse``) and the backward kernel."""

    @staticmethod
    def forward(ctx, q, k, v, causal, window):
        o, lse = flash_attention(q, k, v, causal=causal, window=window,
                                 return_lse=True)
        ctx.save_for_backward(q, k, v, o, lse)
        ctx.mask = (causal, window)
        return o

    @staticmethod
    def backward(ctx, do):
        q, k, v, o, lse = ctx.saved_tensors
        causal, window = ctx.mask
        dq, dk, dv = flash_attention_bwd(q, k, v, o, lse, do, causal=causal,
                                         window=window)
        return dq, dk, dv, None, None


def flash_attention_autograd(q: torch.Tensor, k: torch.Tensor,
                             v: torch.Tensor, *, causal: bool = True,
                             window: Optional[int] = None) -> torch.Tensor:
    """``flash_attention`` that autograd differentiates through
    ``flash_attention_bwd`` (on the CPU, through the plain versions).
    Without a gradient to take it is ``flash_attention`` itself, which
    writes no ``lse``."""
    if torch.is_grad_enabled() and any(t.requires_grad for t in (q, k, v)):
        return _FlashAttention.apply(q, k, v, causal, window)
    return flash_attention(q, k, v, causal=causal, window=window)
