"""Convert a JAX parameter pytree of the reference into the port's modules.

``from_jax_params(params_np, cfg)`` takes the reference's ``init_lm`` pytree
(``init_encdec``'s for an encoder-decoder config) with every leaf as a numpy
array (``np.asarray`` of each leaf) and returns the port's ``LM`` (or
``EncDec``) module holding the same values.  Stacked blocks
(``scan_layers=True``: one dict of ``[L, ...]`` arrays, nested sub-dicts
such as the hybrid's ``mamba`` included) and listed blocks both convert.
``load_params`` does the same for any sub-module whose attribute paths are
the pytree's keys (an ``MoE``, an ``Attention``, ...).
"""

from __future__ import annotations

from typing import Any, Dict

import numpy as np
import torch
from torch import nn

from .configs.registry import ModelConfig
from .launch.mesh import resolve_device
from .models.encdec import EncDec
from .models.transformer import LM

__all__ = ["from_jax_params", "load_params", "to_torch"]


def to_torch(a: Any) -> torch.Tensor:
    """A numpy array as a CPU tensor of the same dtype and bits (bfloat16
    arrays included)."""
    a = np.asarray(a)
    if a.dtype.name == "bfloat16":
        return torch.from_numpy(a.view(np.uint16).copy()).view(torch.bfloat16)
    return torch.from_numpy(a.copy())


def _flatten(tree: Any, prefix: str, out: Dict[str, Any]) -> None:
    if isinstance(tree, dict):
        for k, v in tree.items():
            _flatten(v, f"{prefix}{k}.", out)
    elif isinstance(tree, (list, tuple)):
        for i, v in enumerate(tree):
            _flatten(v, f"{prefix}{i}.", out)
    else:
        out[prefix[:-1]] = tree


def load_params(module: nn.Module, params_np: Any) -> nn.Module:
    """Copy the pytree ``params_np`` into ``module`` (strict: every key of
    one must be a parameter of the other).  Values are cast to each
    parameter's dtype, as the reference casts at use."""
    flat: Dict[str, Any] = {}
    _flatten(params_np, "", flat)
    state = {k: to_torch(v) for k, v in flat.items()}
    module.load_state_dict(state, strict=True)
    return module


def from_jax_params(params_np: Dict[str, Any], cfg: ModelConfig,
                    device="cuda", train: bool = False) -> nn.Module:
    """The reference's model pytree (numpy leaves) as the port's ``LM``, or
    ``EncDec`` for an encoder-decoder config (``train=True``: trainable, the
    expert stacks kept as f32 masters)."""
    dev = resolve_device(device)
    gen = torch.Generator(device=dev).manual_seed(0)
    if cfg.encdec:
        with torch.no_grad():
            return load_params(EncDec(cfg, gen, dev, train), params_np)
    tree = dict(params_np)
    blocks = tree["blocks"]
    if isinstance(blocks, dict):  # stacked: split the leading layer axis
        def split(t, i):
            if isinstance(t, dict):
                return {k: split(v, i) for k, v in t.items()}
            return np.asarray(t)[i]
        tree["blocks"] = [split(blocks, i) for i in range(cfg.n_layers)]
    with torch.no_grad():
        return load_params(LM(cfg, gen, dev, train), tree)
