"""Seeded weights, made by the benchmark and handed to both sides.

Each leaf is filled in one call on its device from a generator seeded by
the run's seed and the leaf's name, so the program's copy and the
reference's copy (made again after the program is freed) hold the same
values, and one leaf can be made again alone.  Leaves are named as the
architecture's parameters (``blocks.<i>.attn.wq``, ...); the expert stacks
are served in the compute dtype and trained as f32 masters, every other
leaf is f32.
"""

from __future__ import annotations

import hashlib
import math
from typing import Dict, List, NamedTuple, Tuple

import torch


class Leaf(NamedTuple):
    name: str
    shape: Tuple[int, ...]
    dtype: torch.dtype
    std: float          # 0: filled with ones (a norm's scale)


def leaves(m: dict, train: bool) -> List[Leaf]:
    """Every leaf of the model ``m`` (``yardstick.config_widths``)."""
    d, h, kv, dh = m["d_model"], m["n_heads"], m["n_kv_heads"], m["head_dim"]
    f, e, v = m["d_ff"], m["num_experts"], m["vocab"]
    f32 = torch.float32
    experts = f32 if train else getattr(torch, m["compute_dtype"])
    out = [Leaf("embed", (v, d), f32, 0.02),
           Leaf("final_norm.scale", (d,), f32, 0.0),
           Leaf("lm_head", (d, v), f32, 0.02)]
    for i in range(m["n_layers"]):
        p = f"blocks.{i}."
        out += [
            Leaf(p + "norm1.scale", (d,), f32, 0.0),
            Leaf(p + "attn.wq", (d, h * dh), f32, 1 / math.sqrt(d)),
            Leaf(p + "attn.wk", (d, kv * dh), f32, 1 / math.sqrt(d)),
            Leaf(p + "attn.wv", (d, kv * dh), f32, 1 / math.sqrt(d)),
            Leaf(p + "attn.wo", (h * dh, d), f32, 1 / math.sqrt(h * dh)),
            Leaf(p + "norm2.scale", (d,), f32, 0.0),
            Leaf(p + "moe.router", (d, e), f32, 1 / math.sqrt(d)),
            Leaf(p + "moe.w_gate", (e, d, f), experts, 1 / math.sqrt(d)),
            Leaf(p + "moe.w_up", (e, d, f), experts, 1 / math.sqrt(d)),
            Leaf(p + "moe.w_down", (e, f, d), experts, 1 / math.sqrt(f)),
        ]
    return out


def leaf_seed(seed: int, name: str) -> int:
    """A 63-bit generator seed from the run's seed and a leaf's name."""
    digest = hashlib.sha256(f"{int(seed)}:{name}".encode()).digest()
    return int.from_bytes(digest[:8], "little") & ((1 << 63) - 1)


def fill(t: torch.Tensor, leaf: Leaf, seed: int) -> torch.Tensor:
    """Fill ``t`` (the leaf's shape and dtype) in place with its values."""
    if tuple(t.shape) != leaf.shape or t.dtype != leaf.dtype:
        raise ValueError(f"{leaf.name}: got {tuple(t.shape)} {t.dtype}, "
                         f"want {leaf.shape} {leaf.dtype}")
    if leaf.std == 0.0:
        return t.fill_(1.0)
    gen = torch.Generator(device=t.device)
    gen.manual_seed(leaf_seed(seed, leaf.name))
    return t.normal_(0.0, leaf.std, generator=gen)


def make(leaf: Leaf, seed: int, device) -> torch.Tensor:
    """A fresh tensor holding the leaf's values."""
    return fill(torch.empty(leaf.shape, dtype=leaf.dtype, device=device),
                leaf, seed)


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


class LayerLeaves:
    """``name -> f32 tensor``: leaves made on demand, keeping the top-level
    ones and those of the last layer asked for (a reference that goes
    layer by layer holds one layer's)."""

    def __init__(self, m: dict, train: bool, seed: int, device):
        self.by_name = {leaf.name: leaf for leaf in leaves(m, train)}
        self.seed, self.device = seed, device
        self.cache: Dict[str, torch.Tensor] = {}

    def __call__(self, name: str) -> torch.Tensor:
        t = self.cache.get(name)
        if t is None:
            if name.startswith("blocks."):
                layer = name.split(".")[1]
                for k in [k for k in self.cache if k.startswith("blocks.")
                          and k.split(".")[1] != layer]:
                    del self.cache[k]
            t = make(self.by_name[name], self.seed, self.device).float()
            self.cache[name] = t
        return t
