"""The benchmark's seeded leaves of a model whose norms may be LayerNorms.

``weights.leaves`` are the RMS-norm models' leaves.  Where the
configuration's model says ``"norm": "layernorm"`` (DBRX), the program
holds a bias beside each norm's scale; the published model has none, so
each such bias is a leaf of zeros, and the reference reads the scales
alone.  Every other leaf is ``weights``' own, seeded by
``weights.leaf_seed`` and filled by ``weights.fill``.
"""

from __future__ import annotations

from typing import Dict, List

import torch

from . import weights
from .weights import Leaf


def leaves(m: dict, train: bool) -> List[Leaf]:
    """Every leaf of the model ``m`` (``yardstick.config_widths``)."""
    out = weights.leaves(m, train)
    if m.get("norm", "rmsnorm") != "layernorm":
        return out
    # every ".scale" leaf is a norm's
    return out + [leaf._replace(name=leaf.name[:-len("scale")] + "bias")
                  for leaf in out if leaf.name.endswith(".scale")]


def fill(t: torch.Tensor, leaf: Leaf, seed: int) -> torch.Tensor:
    """``weights.fill``, and zeros for a norm's bias."""
    if leaf.name.endswith(".bias"):
        return t.zero_()
    return weights.fill(t, leaf, seed)


def fill_named(named: Dict[str, torch.Tensor], m: dict, train: bool,
               seed: int) -> None:
    """Fill every tensor of ``named`` (a program's parameters by name),
    which must hold exactly the leaves of ``m``."""
    want = {leaf.name: leaf for leaf in leaves(m, train)}
    if set(named) != set(want):
        raise ValueError(
            f"the program's parameters differ from the benchmark's leaves: "
            f"missing {sorted(set(want) - set(named))}, extra "
            f"{sorted(set(named) - set(want))}")
    with torch.no_grad():
        for name, t in named.items():
            fill(t, want[name], seed)
