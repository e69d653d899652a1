"""Convert a JAX parameter pytree of the reference into the port's modules.

``from_jax_params(params_np, cfg)`` takes the reference's ``init_lm`` pytree
(``init_encdec``'s for an encoder-decoder config) with every leaf as a numpy
array (``np.asarray`` of each leaf) and returns the port's ``LM`` (or
``EncDec``) module holding the same values.  Stacked blocks
(``scan_layers=True``: one dict of ``[L, ...]`` arrays, nested sub-dicts
such as the hybrid's ``mamba`` included) and listed blocks both convert.
``load_params`` does the same for any sub-module whose attribute paths are
the pytree's keys (an ``MoE``, an ``Attention``, ...).

One process's shard: ``shard_params(params_np, specs, mesh, coords)`` cuts
the reference's pytree by the spec tree of ``launch/shardings.param_specs``
and ``from_jax_params(..., shard=True)`` loads the cut; ``shard_module``
cuts a port module's tensors (on the card, or shared with this process by
its parent) by ``module_specs`` into a module of their own.  A shard module
is built on the ``meta`` device and takes its tensors as they are: an MoE
there holds its rank's ``E_loc`` experts.
"""

from __future__ import annotations

from typing import Any, Dict, Optional

import numpy as np
import torch
from torch import nn

from .configs.registry import ModelConfig
from .launch.mesh import resolve_device
from .models.encdec import EncDec
from .models.transformer import LM

__all__ = ["from_jax_params", "load_params", "to_torch", "shard_params",
           "shard_module", "recast"]


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


def _shell(cfg: ModelConfig, train: bool) -> nn.Module:
    """The port's module for ``cfg`` on the meta device (no memory)."""
    cls = EncDec if cfg.encdec else LM
    return cls(cfg, torch.Generator(), torch.device("meta"), train)


def _assign(module: nn.Module, named: Dict[str, torch.Tensor],
            device: torch.device) -> nn.Module:
    """Put ``named`` tensors in place of ``module``'s parameters (strict on
    the names; any shapes), cast to each parameter's dtype on ``device``."""
    own = dict(module.named_parameters())
    if set(own) != set(named):
        raise KeyError(f"parameters differ: missing "
                       f"{sorted(set(own) - set(named))[:4]}, unexpected "
                       f"{sorted(set(named) - set(own))[:4]}")
    for name, t in named.items():
        *path, leaf = name.split(".")
        sub = module.get_submodule(".".join(path))
        t = t.to(device=device, dtype=own[name].dtype)
        setattr(sub, leaf, nn.Parameter(
            t, requires_grad=own[name].requires_grad))
    return module


def from_jax_params(params_np: Dict[str, Any], cfg: ModelConfig,
                    device="cuda", train: bool = False,
                    shard: bool = False) -> nn.Module:
    """The reference's model pytree (numpy leaves) as the port's ``LM``, or
    ``EncDec`` for an encoder-decoder config (``train=True``: trainable, the
    expert stacks kept as f32 masters).  ``shard=True`` takes the leaves'
    shapes as they are (one process's cut, ``shard_params``)."""
    dev = resolve_device(device)
    if shard:
        flat: Dict[str, Any] = {}
        _flatten(_split_blocks(params_np, cfg), "", flat)
        with torch.no_grad():
            return _assign(_shell(cfg, train),
                           {k: to_torch(v) for k, v in flat.items()}, dev)
    gen = torch.Generator(device=dev).manual_seed(0)
    if cfg.encdec:
        with torch.no_grad():
            return load_params(EncDec(cfg, gen, dev, train), params_np)
    with torch.no_grad():
        return load_params(LM(cfg, gen, dev, train),
                           _split_blocks(params_np, cfg))


def _split_blocks(params_np: Dict[str, Any], cfg: ModelConfig
                  ) -> Dict[str, Any]:
    """A stacked (scanned) block dict split into one tree per layer."""
    tree = dict(params_np)
    blocks = tree.get("blocks")
    if isinstance(blocks, dict):  # stacked: split the leading layer axis
        def split(t, i):
            if isinstance(t, dict):
                return {k: split(v, i) for k, v in t.items()}
            return np.asarray(t)[i]
        tree["blocks"] = [split(blocks, i) for i in range(cfg.n_layers)]
    return tree


def shard_params(params: Any, specs: Any, mesh, coords) -> Any:
    """The reference's parameter pytree (numpy leaves) cut to the shard of
    the rank at ``coords`` (one coordinate per mesh axis) by ``specs``, a
    spec tree of the same layout (``launch/shardings.param_specs``)."""
    from .launch.shardings import (flatten_with_path, shard_tensor,
                                   tree_map_with_path)

    flat = flatten_with_path(specs)
    return tree_map_with_path(
        lambda path, a: np.ascontiguousarray(shard_tensor(
            np.asarray(a), flat[path], mesh, coords)), params)


def shard_module(params: Any, cfg: ModelConfig, mesh,
                 device: Optional[Any] = None, train: bool = False
                 ) -> nn.Module:
    """This process's shard of a port module (or its ``{name: tensor}``),
    by ``launch/shardings.module_specs`` on ``mesh`` (a ``ProcessMesh``),
    copied onto ``device`` (default: the mesh's) into a module of its own:
    the whole can be dropped after.  A "model" axis above 1 cuts the
    reference's TP slices (the query, key and value columns, also where
    they cut through a head, the FFN's and the experts' hidden dim, the
    vocabulary, the recurrent blocks' and Mamba's columns and channels;
    ``models/tp.py`` and ``models/ssm.py`` run them), and keeps whole each
    leaf whose dim "model" does not divide (``_drop_uneven``), for every
    family; under ``pure_dp`` every leaf but an expert stack's EP dim is
    whole.  Under FSDP each leaf of two or more dims is also cut over the
    intra-pod DP axes (per layer: ``module_specs``), which
    ``models/fsdp.py`` gathers before use."""
    from .launch.shardings import module_specs, named_params, shard_tensor

    dev = mesh.device if device is None else resolve_device(device)
    named = named_params(params)
    specs = module_specs(cfg, mesh, named)
    local = {}
    with torch.no_grad():
        for k, v in named.items():
            local[k] = shard_tensor(v.detach(), specs[k], mesh).to(
                device=dev, copy=True).contiguous()
        return _assign(_shell(cfg, train), local, dev)


def recast(params: Any, cfg: ModelConfig, device: Optional[Any] = None,
           train: bool = False) -> nn.Module:
    """The port module of ``cfg`` holding ``params``' tensors (a module or
    ``{name: tensor}``, whole or one process's shard), each cast to the
    dtype ``cfg`` keeps it in: a tensor that already has it is shared, not
    copied.  Serving a bf16 config from f32 parameters casts the expert
    stacks alone (``models/moe.py`` keeps them in the compute dtype)."""
    from .launch.shardings import named_params

    named = named_params(params)
    dev = next(iter(named.values())).device if device is None \
        else resolve_device(device)
    with torch.no_grad():
        return _assign(_shell(cfg, train), dict(named), dev)
