"""Roofline terms of one rank's program on an NVIDIA H100, and the counter
that measures a program's operations, bytes and collectives.

Counterpart of ``src/repro/launch/roofline.py``.  Three terms a rank:

    compute    = flops_per_chip / peak_flops                    [s]
    memory     = bytes_per_chip / hbm_bw                        [s]
    collective = ici_bytes / link_bw + dcn_bytes / dcn_bw       [s]

The reference reads the FLOPs and bytes of a compiled program from XLA's
cost analysis and parses its collectives out of the optimized HLO
(``parse_collectives``).  The port has no HLO, so nothing here parses one.
``count()`` runs the program instead, on the card, the CPU or meta
tensors, and counts:

* FLOPs by ``torch.utils.flop_counter``'s formulas over the aten ops (the
  matrix products and attention; an elementwise op counts none);
* bytes accessed as each aten op's inputs plus outputs (XLA's "bytes
  accessed" in the same sense), nothing for a view, an empty allocation, a
  copy between devices or the upload of a host constant (``torch.tensor``
  of Python data, copied to the device: on the CPU a dtype conversion);
* the collectives of ``launch/mesh.py``'s process mesh, reported by its
  three transports (``collective``) before they move anything: the op, the
  group's size, the bytes its operand holds, and the tier, ``pod`` among
  the axes being the slow one.

The hand-written kernels are ctypes calls that the dispatch mode cannot
see, so each wrapper reports its own formula (``counted``), and nothing run
inside it is counted: a kernel call counts the same on the card (the
kernel), on the CPU (its plain version) and on meta (an empty output).
The formulas are those of the kernels' bounds (``gmm_cost``,
``attn_cost``, ``attn_bwd_cost``, ``copy_cost``, ``adamw_cost``,
``sq_norm_cost``).
"""

from __future__ import annotations

import contextlib
import dataclasses
import weakref
from typing import Dict, Iterator, List, Optional, Sequence, Tuple

import numpy as np
import torch

__all__ = ["HW", "CollectiveStats", "Counts", "roofline_terms", "count",
           "collective", "counted", "devices", "quiet",
           "gmm_cost", "band_pairs", "attn_cost", "attn_bwd_cost",
           "copy_cost", "adamw_cost", "sq_norm_cost", "PEAK_FLOPS",
           "PEAK_FLOPS_BY_DTYPE", "HBM_BW", "LINK_BW", "DCN_BW"]

# NVIDIA H100 SXM per-card constants
PEAK_FLOPS = 989e12          # bf16 dense: vendor spec
PEAK_FLOPS_BY_DTYPE = {"bfloat16": PEAK_FLOPS,
                       "float32": 67e12}       # f32 dense, no TF32: vendor
HBM_BW = 3.35e12             # bytes/s, HBM3: vendor spec
LINK_BW = 450e9              # bytes/s a direction, NVLink 4: an assumption
DCN_BW = 50e9                # bytes/s, one 400 Gb/s NIC rail: an assumption


@dataclasses.dataclass(frozen=True)
class HW:
    peak_flops: float = PEAK_FLOPS
    hbm_bw: float = HBM_BW
    link_bw: float = LINK_BW
    dcn_bw: float = DCN_BW


def _wire_bytes(op: str, result_bytes: int, n: int) -> float:
    """The bytes a rank puts on the wire for ``op`` over a group of ``n``,
    from the result's bytes (ring all-reduce moves about twice its operand,
    an all-to-all ``(n - 1) / n`` of it, a permute all of it)."""
    if n <= 1:
        return 0.0
    if op == "all-reduce":
        return 2.0 * result_bytes * (n - 1) / n
    if op == "all-gather":
        return result_bytes * (n - 1) / n        # result is gathered size
    if op == "reduce-scatter":
        return result_bytes * (n - 1)            # result is scattered shard
    if op == "all-to-all":
        return result_bytes * (n - 1) / n
    if op == "collective-permute":
        return float(result_bytes)
    return float(result_bytes)


@dataclasses.dataclass
class CollectiveStats:
    simple_bytes: float = 0.0       # sum of the operands' sizes
    wire_bytes: float = 0.0         # ring/permute-aware per-chip estimate
    # wire bytes on the fast tier (NVLink inside a node: every axis but
    # "pod") and on the slow one (the NIC rails between nodes: "pod");
    # the reference's names
    ici_bytes: float = 0.0
    dcn_bytes: float = 0.0
    by_op: Dict[str, float] = dataclasses.field(default_factory=dict)
    count: int = 0
    # {op: {"ici": wire bytes, "dcn": wire bytes}}
    by_tier: Dict[str, Dict[str, float]] = dataclasses.field(
        default_factory=dict)


def roofline_terms(flops_per_chip: float, bytes_per_chip: float,
                   coll: CollectiveStats, hw: HW = HW()) -> Dict[str, float]:
    compute = flops_per_chip / hw.peak_flops
    memory = bytes_per_chip / hw.hbm_bw
    collective_simple = coll.simple_bytes / hw.link_bw
    collective = coll.ici_bytes / hw.link_bw + coll.dcn_bytes / hw.dcn_bw
    dominant = max(
        [("compute", compute), ("memory", memory),
         ("collective", collective)], key=lambda kv: kv[1])[0]
    bound = max(compute, memory, collective)
    frac = compute / bound if bound > 0 else 0.0
    return {
        "compute_s": compute,
        "memory_s": memory,
        "collective_s": collective,
        "collective_simple_s": collective_simple,
        "ici_bytes": coll.ici_bytes,
        "dcn_bytes": coll.dcn_bytes,
        "dominant": dominant,
        "roofline_fraction": frac,   # compute term / binding term
    }


# -- the kernels' formulas ------------------------------------------------------

def gmm_cost(e: int, c: int, d: int, f: int, elem: int) -> Tuple[int, int]:
    """(operations, bytes) of ``[E, C, D] @ [E, D, F]``: 2·E·C·D·F, padded
    rows included; x and w read and y written once."""
    return 2 * e * c * d * f, (e * c * d + e * d * f + e * c * f) * elem


def band_pairs(s: int, causal: bool, window: Optional[int]) -> int:
    """Visible (query, key) pairs of one head of ``s`` tokens."""
    q = np.arange(s, dtype=np.int64)
    hi = q if causal else np.full(s, s - 1, np.int64)
    lo = np.maximum(0, q - window + 1) if window else np.zeros(s, np.int64)
    return int(np.clip(hi - lo + 1, 0, None).sum())


def attn_cost(b: int, h: int, kv: int, s: int, d: int, causal: bool,
              window: Optional[int], elem: int) -> Tuple[int, int]:
    """(operations, bytes) of one ``flash_attention`` call: 4·D operations
    per visible pair and head; q, k, v read and o written once."""
    return (4 * b * h * d * band_pairs(s, causal, window),
            (2 * b * h + 2 * b * kv) * s * d * elem)


def attn_bwd_cost(b: int, h: int, kv: int, s: int, d: int, causal: bool,
                  window: Optional[int], elem: int) -> Tuple[int, int]:
    """(operations, bytes) of one ``flash_attention_bwd`` call: 10·D
    operations per visible pair and head; q, o, dO, k, v and the f32 lse
    read once, dq, dk, dv written once."""
    return (10 * b * h * d * band_pairs(s, causal, window),
            (4 * b * h + 4 * b * kv) * s * d * elem + 4 * b * h * s)


def copy_cost(moved_bytes: int) -> Tuple[int, int]:
    """(operations, bytes) of a block copy (``a2a_pack`` / ``a2a_unpack``):
    none; the moved bytes read and written once."""
    return 0, 2 * moved_bytes


def adamw_cost(elems: int, param_bytes: int, grad_bytes: int
               ) -> Tuple[int, int]:
    """(operations, bytes) of ``adamw_step`` over ``elems`` parameters of
    ``param_bytes`` each with gradients of ``grad_bytes``: none (an
    elementwise op counts none); the parameter, its gradient and its two
    f32 moments read once, the parameter and the moments written once."""
    return 0, elems * (2 * param_bytes + grad_bytes + 16)


def sq_norm_cost(grad_bytes: int, leaves: int) -> Tuple[int, int]:
    """(operations, bytes) of ``sq_norm`` over ``leaves`` gradients of
    ``grad_bytes`` in all: none; each read once, one f32 written a leaf."""
    return 0, grad_bytes + 4 * leaves


# -- the counter ----------------------------------------------------------------

@dataclasses.dataclass
class Counts:
    """What ``count()`` measured: ``flops`` and ``bytes`` of every aten op
    and kernel call, ``collectives`` (the process mesh's), and ``kernels``
    (``{name: {"calls", "flops", "bytes"}}``, included in the totals)."""

    flops: int = 0
    bytes: int = 0
    collectives: CollectiveStats = dataclasses.field(
        default_factory=CollectiveStats)
    kernels: Dict[str, Dict[str, int]] = dataclasses.field(
        default_factory=dict)

    def summary(self) -> dict:
        c = self.collectives
        return {"flops": self.flops, "bytes": self.bytes,
                "kernels": {k: dict(v) for k, v in self.kernels.items()},
                "collectives": {
                    "count": c.count, "simple_bytes": c.simple_bytes,
                    "wire_bytes": c.wire_bytes, "ici_bytes": c.ici_bytes,
                    "dcn_bytes": c.dcn_bytes, "by_op": dict(c.by_op),
                    "by_tier": {k: dict(v) for k, v in c.by_tier.items()}}}


_ACTIVE: List[Counts] = []
_QUIET = [0]


@contextlib.contextmanager
def quiet() -> Iterator[None]:
    """Count no aten op inside: a kernel's own work (its formula stands for
    it) or a collective's transport (its report stands for it)."""
    _QUIET[0] += 1
    try:
        yield
    finally:
        _QUIET[0] -= 1


def devices() -> Tuple[str, ...]:
    """The device types a kernel wrapper takes: the CPU and CUDA, and meta
    while a ``count()`` is active (the dry run: there a call's formula is
    all of its result, and a meta tensor stands for the card's)."""
    return ("cpu", "cuda", "meta") if _ACTIVE else ("cpu", "cuda")


@contextlib.contextmanager
def counted(name: str, cost: Tuple[int, int]) -> Iterator[None]:
    """A kernel wrapper's body: reports one call of ``name`` at ``cost``
    (its formula's operations and bytes) and counts nothing run inside."""
    flops, nbytes = (int(v) for v in cost)
    if not _QUIET[0]:
        for rec in _ACTIVE:
            k = rec.kernels.setdefault(name, {"calls": 0, "flops": 0,
                                              "bytes": 0})
            k["calls"] += 1
            k["flops"] += flops
            k["bytes"] += nbytes
            rec.flops += flops
            rec.bytes += nbytes
    with quiet():
        yield


def collective(op: str, axes: Sequence[str], n: int, nbytes: int) -> None:
    """A process collective's report, made before its transport: ``op`` (the
    reference's HLO name: ``all-to-all``, ``collective-permute``,
    ``all-reduce``) over ``axes``, a group of ``n``, on an operand of
    ``nbytes``.  A group of one moves nothing and is not counted."""
    if n <= 1 or not _ACTIVE:
        return
    tier = "dcn" if "pod" in tuple(axes) else "ici"
    wire = _wire_bytes(op, nbytes, n)
    for rec in _ACTIVE:
        c = rec.collectives
        c.simple_bytes += nbytes
        c.wire_bytes += wire
        if tier == "dcn":
            c.dcn_bytes += wire
        else:
            c.ici_bytes += wire
        c.by_op[op] = c.by_op.get(op, 0.0) + wire
        tiers = c.by_tier.setdefault(op, {"ici": 0.0, "dcn": 0.0})
        tiers[tier] += wire
        c.count += 1


def _tensors(tree) -> List[torch.Tensor]:
    from torch.utils._pytree import tree_flatten

    return [t for t in tree_flatten(tree)[0] if isinstance(t, torch.Tensor)]


def _nbytes(t: torch.Tensor) -> int:
    return t.numel() * t.element_size()


_aten = torch.ops.aten
# ops that move no data: allocations without a value, views the schema
# does not mark, a host read of a scalar
_NO_TRAFFIC = {_aten.empty, _aten.empty_like, _aten.empty_strided,
               _aten.new_empty, _aten.new_empty_strided, _aten._unsafe_view,
               _aten.lift_fresh, _aten._local_scalar_dense}
_COPIES = {_aten._to_copy, _aten.copy_, _aten.copy}


def _dead():
    return None


def _is_view(func) -> bool:
    """The op returns an alias of an input that it does not write: a
    view."""
    return any(r.alias_info is not None and not r.alias_info.is_write
               for r in func._schema.returns)


def _op_bytes(func, args, kwargs, out, lifted=None) -> int:
    """The bytes ``func`` reads and writes; ``lifted`` maps ``id()`` to a
    weak reference of each host constant made so far (``torch.tensor`` of
    Python data)."""
    lifted = {} if lifted is None else lifted
    if func._overloadpacket in _NO_TRAFFIC or _is_view(func):
        return 0
    ins, outs = _tensors((args, kwargs)), _tensors(out)
    if func._overloadpacket in _COPIES and (
            len({t.device for t in ins + outs}) > 1
            or any(lifted.get(id(t), _dead)() is t for t in ins)):
        return 0   # between the host and a device, or a constant's upload
    return sum(_nbytes(t) for t in ins) + sum(_nbytes(t) for t in outs)


class _Mode(torch.utils._python_dispatch.TorchDispatchMode):

    def __init__(self, rec: Counts):
        super().__init__()
        self.rec = rec
        from torch.utils.flop_counter import flop_registry

        self.registry = flop_registry
        self.lifted = {}

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        kwargs = kwargs or {}
        out = func(*args, **kwargs)
        if func._overloadpacket is _aten.lift_fresh:
            self.lifted[id(out)] = weakref.ref(out)
        if not _QUIET[0]:
            formula = self.registry.get(func._overloadpacket)
            if formula is not None:
                self.rec.flops += int(formula(*args, **kwargs, out_val=out))
            self.rec.bytes += _op_bytes(func, args, kwargs, out, self.lifted)
        return out


@contextlib.contextmanager
def count() -> Iterator[Counts]:
    """Count what the program run inside does: yields a ``Counts`` that
    fills as it runs."""
    rec = Counts()
    _ACTIVE.append(rec)
    try:
        with _Mode(rec):
            yield rec
    finally:
        _ACTIVE.remove(rec)
