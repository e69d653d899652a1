"""Blockwise (flash) attention with GQA, causal masking and a sliding window.

Hopper counterpart of ``src/repro/kernels/flash_attention/flash_attention.py``
(``flash_attention``, Pallas body ``_flash_kernel``): forward-only online
softmax attention on ``q [B, H, S, D]`` and ``k``/``v [B, K, S, D]``, the kv
head of query head ``h`` being ``h // (H / K)``, masked with the finite
``-1e30``, output ``acc / max(l, 1e-30)`` in q's dtype.  The CUDA kernel is
``csrc/flash_attention.cu``: one block per (batch * head, 64-row q tile)
loops over exactly the kv tiles that meet the causal band and the window, on
the tensor cores (WMMA) in bf16 and with plain f32 FMAs (no TF32) in f32.
It takes any ``S >= 1`` (the TPU kernel needs ``S`` to divide its blocks)
and any head dim up to 128.  It is bound by the operations, 4 * D per
visible (q, k) pair and head.

A CPU tensor goes to the plain version in ``ref.py``; a CUDA tensor launches
the kernel or raises.  ``flash_attention.launches`` counts kernel launches.
"""

from __future__ import annotations

import ctypes
from typing import Optional

import torch

from ... import _build
from .ref import attention_ref

__all__ = ["flash_attention"]

_DTYPES = {torch.float32: 0, torch.bfloat16: 1}
_MAX_HEAD_DIM = 128
_INT_MAX = 2 ** 31 - 1


def _fn():
    fn = _build.load("flash_attention").flash_attention
    if fn.argtypes is None:  # 64-bit pointers need declared argtypes
        fn.argtypes = [ctypes.c_void_p] * 4 + [ctypes.c_int] * 7 + [
            ctypes.c_float, ctypes.c_int, ctypes.c_void_p]
        fn.restype = ctypes.c_int
    return fn


def flash_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
                    causal: bool = True,
                    window: Optional[int] = None) -> torch.Tensor:
    """Attention of ``q [B, H, S, D]`` over ``k``/``v [B, K, S, D]``.

    ``causal`` keeps keys at or before each query; ``window`` (None or
    >= 1) keeps the ``window`` keys ending at the query's position.
    Returns ``[B, H, S, D]`` in q's dtype.
    """
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
    # checked on every device, so that a CPU run finds what the card refuses
    if q.device.type not in ("cpu", "cuda") or not (
            k.device == q.device and v.device == q.device):
        raise ValueError(f"flash_attention takes CPU or CUDA tensors on one "
                         f"device, got {q.device}, {k.device}, {v.device}")
    if q.dtype not in _DTYPES or not (k.dtype == q.dtype
                                      and v.dtype == q.dtype):
        raise ValueError(f"flash_attention takes f32 or bf16 q, k, v of one "
                         f"dtype, got {q.dtype}, {k.dtype}, {v.dtype}")
    if not 1 <= d <= _MAX_HEAD_DIM:
        raise ValueError(f"flash_attention takes head dims 1 to "
                         f"{_MAX_HEAD_DIM}, got {d}")
    if not (q.is_contiguous() and k.is_contiguous() and v.is_contiguous()):
        raise ValueError("flash_attention needs contiguous q, k and v")
    if window is not None and not 1 <= window <= _INT_MAX:
        raise ValueError(f"window must be None or in [1, 2**31), got "
                         f"{window}")
    if max(b * h * s, s * d) > _INT_MAX:
        raise ValueError("flash_attention dimensions must fit in int32")
    if q.device.type == "cpu":
        return attention_ref(q, k, v, causal=causal, window=window)
    fn = _fn()
    o = torch.empty_like(q)
    with torch.cuda.device(q.device):
        rc = fn(q.data_ptr(), k.data_ptr(), v.data_ptr(), o.data_ptr(),
                b, h, kv, s, d, int(causal),
                -1 if window is None else int(window), 1.0 / d ** 0.5,
                _DTYPES[q.dtype],
                torch.cuda.current_stream(q.device).cuda_stream)
    if rc != 0:
        raise RuntimeError(f"flash_attention launch failed: cudaError {rc}")
    flash_attention.launches += 1
    return o


flash_attention.launches = 0
