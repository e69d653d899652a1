"""AdamW over a whole tree of parameters: the gradients' per-leaf sums of
squares (``sq_norm``) and one fused update (``adamw_step``), each a
multi-tensor launch of ``csrc/adamw.cu``.

Replaces no TPU kernel: the reference's AdamW (``src/repro/optim/adamw.py``)
is plain ``jnp`` that XLA fuses.  Both kernels are bound by device-memory
bytes: the update reads each parameter, its gradient and its two f32
moments once and writes the parameter and the moments once (28 B a f32
parameter), the norm reads each gradient once (4 B); the plain version's
16 or so passes a leaf move about 152 B.  Two passes are the least, since
the clip needs the whole tree's norm before any update.

``plan`` cuts a list of leaves (by element count) into launches of at most
``CAPACITY`` leaves and each leaf into blocks of ``BLOCK_ELEMS`` elements,
numbered from 0 in its launch, the last block of a leaf holding its tail;
the table of a launch (pointers, sizes, first blocks) travels in the
kernel's arguments.  Leaves are grouped by dtype (the gradients' for the
norm, the parameters' and the gradients' for the update), one launch or
more a group.  The norm's sums are fixed by the blocks alone (no float
atomics): the same gradients give the same bits on every call.  The clip
scale is read from the norm on the device: no sync.

Checked on every device, so that a CPU run finds what the card refuses:
each tensor f32 or bf16, contiguous, all on one device; the moments f32;
each leaf's four tensors of one shape.  On the card every tensor must also
start on 16 bytes (the kernels' 128-bit loads).  A CPU tensor goes to the
plain versions in ``ref.py``; a CUDA tensor launches the kernel or raises;
a meta tensor, taken only while ``launch/roofline.count()`` is active (the
dry run), gets an empty norm and no update.  Each call reports its bytes
to ``launch/roofline.count()`` (``sq_norm_cost``, ``adamw_cost``), and
nothing run inside it is counted.  ``sq_norm.launches`` and
``adamw_step.launches`` count kernel launches; the profiler-gated trace
counter ``adamw.kernel_elems`` counts the elements the update kernel took.
"""

from __future__ import annotations

import ctypes
from typing import Dict, List, NamedTuple, Optional, Sequence, Tuple

import torch

from ... import _build, trace
from ...launch.roofline import adamw_cost, devices, sq_norm_cost
from ...launch.roofline import counted as _counted
from .ref import adamw_step_ref, sq_norm_ref

__all__ = ["sq_norm", "adamw_step", "plan", "Launch", "BLOCK_ELEMS",
           "CAPACITY"]

# elements of a block of the fixed partition, and leaves a launch's table
# holds: csrc/adamw.cu's kBlockElems and kCapacity
BLOCK_ELEMS = 1 << 15
CAPACITY = 64
_DTYPES = {torch.float32: 0, torch.bfloat16: 1}


class Launch(NamedTuple):
    """One launch's leaves (indices into the list planned) and each one's
    first block, then the launch's number of blocks."""
    leaves: Tuple[int, ...]
    first: Tuple[int, ...]


def plan(sizes: Sequence[int], block_elems: int = BLOCK_ELEMS,
         capacity: int = CAPACITY) -> List[Launch]:
    """The launches over leaves of ``sizes`` elements: ``capacity`` leaves
    a launch, in order, each cut into ``ceil(size / block_elems)``
    blocks."""
    out = []
    for lo in range(0, len(sizes), capacity):
        leaves = tuple(range(lo, min(lo + capacity, len(sizes))))
        first = [0]
        for i in leaves:
            first.append(first[-1] + -(-int(sizes[i]) // block_elems))
        out.append(Launch(leaves, tuple(first)))
    return out


def _groups(keys) -> Dict[tuple, List[int]]:
    """Indices of ``keys`` grouped by value, groups in first-seen order."""
    groups: Dict[tuple, List[int]] = {}
    for i, k in enumerate(keys):
        groups.setdefault(k, []).append(i)
    return groups


def _check(tensors: Sequence[torch.Tensor]) -> None:
    device = tensors[0].device
    for t in tensors:
        if t.device.type not in devices():
            raise ValueError(f"the AdamW kernels take CPU or CUDA tensors "
                             f"(and meta ones while counting), not "
                             f"{t.device}")
        if t.device != device:
            raise ValueError(f"the AdamW kernels take tensors on one "
                             f"device: {device} and {t.device}")
        if t.dtype not in _DTYPES:
            raise ValueError(f"the AdamW kernels take f32 or bf16, not "
                             f"{t.dtype}")
        if not t.is_contiguous():
            raise ValueError("the AdamW kernels need contiguous tensors")
        if t.device.type == "cuda" and t.data_ptr() % 16:
            raise ValueError("the AdamW kernels need tensors that start on "
                             "16 bytes")


def _ptrs(tensors) -> ctypes.Array:
    return (ctypes.c_longlong * len(tensors))(*[t.data_ptr()
                                                for t in tensors])


def _longs(values) -> ctypes.Array:
    return (ctypes.c_longlong * len(values))(*values)


_P = ctypes.POINTER(ctypes.c_longlong)


def _norm_fn():
    fn = _build.load("adamw").sq_norm
    if fn.argtypes is None:  # 64-bit pointers need declared argtypes
        fn.argtypes = [ctypes.c_int, _P, _P, _P, ctypes.POINTER(ctypes.c_int),
                       ctypes.c_longlong, ctypes.c_int, ctypes.c_void_p,
                       ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p]
        fn.restype = ctypes.c_int
    return fn


def _step_fn():
    fn = _build.load("adamw").adamw_step
    if fn.argtypes is None:
        fn.argtypes = [ctypes.c_int, _P, _P, _P, _P, _P, _P,
                       ctypes.c_longlong, ctypes.c_int, ctypes.c_int,
                       *[ctypes.c_float] * 9, ctypes.c_void_p,
                       ctypes.c_float, ctypes.c_void_p]
        fn.restype = ctypes.c_int
    return fn


def sq_norm(tensors: Sequence[torch.Tensor]) -> torch.Tensor:
    """``[len(tensors)]`` f32 on their device: each tensor's sum of squares
    in f32."""
    tensors = list(tensors)
    if not tensors:
        return torch.zeros(0)
    _check(tensors)
    dev = tensors[0].device
    cost = sq_norm_cost(sum(t.numel() * t.element_size() for t in tensors),
                        len(tensors))
    with _counted("sq_norm", cost):
        if dev.type == "cpu":
            return sq_norm_ref(tensors)
        out = torch.empty(len(tensors), dtype=torch.float32, device=dev)
        if dev.type == "meta":
            return out
        for dtype, idx in _groups(t.dtype for t in tensors).items():
            for launch in plan([tensors[i].numel() for i in idx]):
                leaves = [idx[j] for j in launch.leaves]
                blocks = launch.first[-1]
                # each block's partial sum, then the last CTA's ticket
                work = torch.empty(blocks + 1, dtype=torch.float32,
                                   device=dev)
                rc = _build.launch(
                    _norm_fn(), dev, len(leaves),
                    _ptrs([tensors[i] for i in leaves]),
                    _longs([tensors[i].numel() for i in leaves]),
                    _longs(launch.first),
                    (ctypes.c_int * len(leaves))(*leaves), BLOCK_ELEMS,
                    _DTYPES[dtype], work.data_ptr(),
                    work.data_ptr() + 4 * blocks, out.data_ptr())
                if rc != 0:
                    raise RuntimeError(f"sq_norm launch failed: cudaError "
                                       f"{rc}")
                sq_norm.launches += 1
    return out


def adamw_step(params: Sequence[torch.Tensor],
               grads: Sequence[torch.Tensor], ms: Sequence[torch.Tensor],
               vs: Sequence[torch.Tensor], *, lr: float, b1: float,
               b2: float, eps: float, weight_decay: float, bc1: float,
               bc2: float, norm: Optional[torch.Tensor] = None,
               clip_norm: Optional[float] = None) -> None:
    """Update each parameter (f32 or bf16) and its f32 moments in place
    from its gradient (f32 or bf16), clipped to ``clip_norm`` by the
    gradients' global ``norm`` (an f32 scalar; no clip when ``clip_norm``
    is None); ``bc1`` and ``bc2`` are this step's bias corrections."""
    params, grads, ms, vs = (list(x) for x in (params, grads, ms, vs))
    if not len(params) == len(grads) == len(ms) == len(vs):
        raise ValueError("adamw_step needs a gradient and two moments a "
                         "parameter")
    if not params:
        return
    _check(params + grads + ms + vs)
    for t in ms + vs:
        if t.dtype != torch.float32:
            raise ValueError(f"AdamW's moments must be f32, not {t.dtype}")
    for p, g, m, v in zip(params, grads, ms, vs):
        if not p.shape == g.shape == m.shape == v.shape:
            raise ValueError(f"a parameter {tuple(p.shape)}, its gradient "
                             f"{tuple(g.shape)} and moments {tuple(m.shape)}"
                             f", {tuple(v.shape)} differ")
    if clip_norm is not None and norm is None:
        raise ValueError("a clip needs the gradients' norm")
    dev = params[0].device
    cost = (0, sum(adamw_cost(p.numel(), p.element_size(),
                              g.element_size())[1]
                   for p, g in zip(params, grads)))
    hyper = dict(lr=lr, b1=b1, b2=b2, eps=eps, weight_decay=weight_decay,
                 bc1=bc1, bc2=bc2, norm=norm, clip_norm=clip_norm)
    with _counted("adamw_step", cost):
        if dev.type == "cpu":
            adamw_step_ref(params, grads, ms, vs, **hyper)
            return
        if dev.type == "meta":
            return
        norm_ptr = None
        if clip_norm is not None:
            if norm.device != dev or norm.dtype != torch.float32 \
                    or norm.numel() != 1:
                raise ValueError(f"the clip needs the norm as one f32 on "
                                 f"{dev}, not {norm.dtype} "
                                 f"{tuple(norm.shape)} on {norm.device}")
            norm_ptr = norm.data_ptr()
        scalars = [float(x) for x in (lr, b1, 1 - b1, b2, 1 - b2, eps,
                                      weight_decay, bc1, bc2)]
        clip = float(clip_norm) if clip_norm is not None else 0.0
        groups = _groups((p.dtype, g.dtype) for p, g in zip(params, grads))
        for (p_dtype, g_dtype), idx in groups.items():
            for launch in plan([params[i].numel() for i in idx]):
                if launch.first[-1] == 0:
                    continue
                leaves = [idx[j] for j in launch.leaves]
                rc = _build.launch(
                    _step_fn(), dev, len(leaves),
                    *(_ptrs([x[i] for i in leaves])
                      for x in (params, grads, ms, vs)),
                    _longs([params[i].numel() for i in leaves]),
                    _longs(launch.first), BLOCK_ELEMS, _DTYPES[p_dtype],
                    _DTYPES[g_dtype], *scalars, norm_ptr, clip)
                if rc != 0:
                    raise RuntimeError(f"adamw_step launch failed: "
                                       f"cudaError {rc}")
                adamw_step.launches += 1
        trace.count("adamw.kernel_elems", sum(p.numel() for p in params))


sq_norm.launches = 0
adamw_step.launches = 0
