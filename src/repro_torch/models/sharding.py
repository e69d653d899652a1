"""Logical-axis sharding rules (MaxText-style) for the model zoo.

Counterpart of ``src/repro/models/sharding.py``.  A ``MeshRules`` binding
maps logical axis names (``"batch"``, ``"heads"``, ...) to mesh axes; a spec
is a tuple of axis entries (``None``, an axis name, or a tuple of names),
the entries of the reference's ``PartitionSpec``.

The reference hands its specs to GSPMD, which places every tensor.  The port
places tensors explicitly (``launch/shardings.py`` cuts a process's shard
with ``shard_tensor``), so ``logical_constraint`` has nothing to constrain
and returns its tensor unchanged; the specs themselves are the reference's.
"""

from __future__ import annotations

import contextlib
import contextvars
import dataclasses
from typing import Any, Optional, Tuple, Union

import torch

__all__ = [
    "MeshRules",
    "use_mesh_rules",
    "current_rules",
    "logical_constraint",
    "logical_spec",
    "DEFAULT_RULES",
]

Axis = Union[None, str, Tuple[str, ...]]
Spec = Tuple[Axis, ...]


@dataclasses.dataclass(frozen=True)
class MeshRules:
    """Logical name -> mesh axis (or None = replicate)."""

    mesh: Any
    batch: Axis = ("pod", "data")
    seq: Axis = None              # sequence usually unsharded...
    act_seq: Axis = None          # ...activation seq dim (SP flips to "model")
    model_dim: Axis = None
    heads: Axis = "model"
    kv_heads: Axis = "model"
    head_dim: Axis = None
    ff: Axis = "model"
    vocab: Axis = "model"
    experts: Axis = None          # EP axes; chosen per arch by choose_ep_axes
    expert_ff: Axis = "model"
    layers: Axis = None
    kv_feature: Axis = "model"    # fused K*dh feature dim of the KV cache

    def spec(self, *names: Optional[str]) -> Spec:
        """Logical names -> spec, deduplicating mesh axes.

        With sequence sharding (act_seq="model") an intermediate like the
        FFN hidden ("batch", "act_seq", "ff") would map "model" twice; the
        RIGHT-most (innermost) use wins and earlier dims replicate, the
        reference's rule.
        """
        entries = [None if n is None else getattr(self, n) for n in names]
        used: set = set()
        out = []
        for e in reversed(entries):
            axes = () if e is None else ((e,) if isinstance(e, str) else e)
            if any(a in used for a in axes):
                out.append(None)
            else:
                used.update(axes)
                out.append(e)
        return tuple(reversed(out))


DEFAULT_RULES = None  # bound per run with use_mesh_rules

_ACTIVE: contextvars.ContextVar[Optional[MeshRules]] = contextvars.ContextVar(
    "repro_torch_mesh_rules", default=None)


@contextlib.contextmanager
def use_mesh_rules(rules: Optional[MeshRules]):
    token = _ACTIVE.set(rules)
    try:
        yield rules
    finally:
        _ACTIVE.reset(token)


def current_rules() -> Optional[MeshRules]:
    return _ACTIVE.get()


def logical_spec(*names: Optional[str]) -> Optional[Spec]:
    rules = current_rules()
    return rules.spec(*names) if rules is not None else None


def logical_constraint(x: torch.Tensor, *names: Optional[str]
                       ) -> torch.Tensor:
    """``x`` unchanged.  The reference's form asks GSPMD to place ``x`` by
    the bound rules; the port places every tensor explicitly (each process
    holds its shard, cut by ``launch/shardings.shard_tensor``), so there is
    nothing to constrain."""
    del names
    return x
