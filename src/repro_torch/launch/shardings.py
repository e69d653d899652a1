"""Parameter / state / batch / cache specs (path-based, MaxText-style), and
the cut of one process's shard.

Counterpart of ``src/repro/launch/shardings.py``: the same tables and
rules, returning for every leaf of a tree a spec (a tuple of axis entries,
the entries of the reference's ``PartitionSpec``) where the reference
returns a ``NamedSharding``.  ``param_specs``, ``cache_specs``,
``batch_specs`` and ``state_specs`` are the counterparts of
``param_shardings``, ``cache_shardings``, ``batch_shardings`` and
``state_shardings``.

Conventions (production mesh: pod x data x model):
  * TP over "model": attention heads / FFN hidden / vocab.
  * DP over ("pod", "data"): batch dim of activations, caches, token inputs.
  * EP over choose_ep_axes(cfg, mesh): expert-stacked MoE weight dim.
  * KV caches shard head_dim over "model" and batch over DP.

A tree is nested dicts, lists and named tuples of tensors (``meta`` ones
stand in for the reference's ``ShapeDtypeStruct``), in the reference's
layout: under ``cfg.scan_layers`` the blocks are one dict of ``[L, ...]``
stacks (``param_tree`` / ``cache_tree`` build it from the port's per-layer
modules and caches; ``module_specs`` maps the specs back to a module's
parameter names).

``shard_tensor`` cuts the slice a rank holds under a spec and
``gather_tensor`` puts the slices back together (on a ``ProcessMesh``, over
its process groups).  On a ``ProcessMesh`` the model code runs the "model"
slices these specs cut (``models/tp.py``), with one deviation: the decode
cache holds the kv heads this process's query heads read (``tp.kv_heads``)
where ``_CACHE_TABLE`` shards ``head_dim``.  Where "model" divides the kv
heads those are this process's own, the same bytes a process as the
reference's.  Where it cuts through them (8 kv heads on the reference's
16-way "model"), each kv head is replicated on the peers whose query heads
read it: twice the reference's cache bytes for megatron-moe-32e at 16, and
no exchange inside attention, where the reference sums the ``dh``-partial
scores ``[B, H, S]`` over "model" in f32 every layer and step, as many
bytes over the fabric as the replicas add to the cache.  Where "model"
cuts through a query head (internvl2-1b's 14 heads at 16), a process's
columns touch one or two query heads and its cache holds the kv heads
those read: the 1 of internvl2-1b's 2 on each process at 16, 8 times the
reference's ``dh / 16`` slice.  An encoder-decoder's cross cache (``xk``,
``xv``, the projected encoder stream) holds the same kv heads as its
self-attention cache.  ``cache_specs`` stays the reference's table;
``whole_kv_heads`` puts the model peers' caches back together.

The recurrent states (``models/ssm.py``) follow ``_CACHE_TABLE`` where
their layout allows: Mamba's ``h [B, d_in, N]`` and ``conv [B, K-1, d_in]``
and the sLSTM's ``c``, ``n`` and ``h`` hold this process's channels, the
reference's shards.  Two quirks: the sLSTM's ``m`` holds its own channels
too, where ``("m", 2)`` keeps it whole; the mLSTM's state holds the heads
its columns touch, ``C [B, h_t, dh, own v columns]`` (the same bytes a
process as the reference's ``C``, which shards every head's v dim), and
``n [B, h_t, dh]`` and ``m [B, h_t]`` whole for those heads, replicated on
the peers that share one where the reference shards ``n``'s ``dh``.
``whole_states`` puts the model peers' states back together.
"""

from __future__ import annotations

import dataclasses
from typing import Any, Callable, Dict, Tuple

import numpy as np
import torch

from ..configs.registry import ModelConfig
from ..models.dist import choose_ep_axes
from ..models.tp import kv_heads, q_heads
from .mesh import ProcessMesh, all_gather

__all__ = ["param_specs", "batch_specs", "cache_specs", "state_specs",
           "spec_tree", "param_tree", "cache_tree", "module_specs",
           "shard_tensor", "gather_tensor", "tree_map_with_path",
           "flatten_with_path", "named_params", "sharded_axes", "fsdp_layout",
           "whole_kv_heads", "whole_states"]

Spec = Tuple[Any, ...]


# trees --------------------------------------------------------------------

def tree_map_with_path(fn: Callable, tree: Any, path: tuple = ()) -> Any:
    """``fn(path, leaf)`` over the tensors of a tree of dicts, lists and
    named tuples; a path holds dict keys (str), list indices (int) and
    named-tuple field names (str)."""
    if isinstance(tree, dict):
        return {k: tree_map_with_path(fn, v, path + (k,))
                for k, v in tree.items()}
    if isinstance(tree, tuple) and hasattr(tree, "_fields"):
        return type(tree)(*[tree_map_with_path(fn, getattr(tree, f),
                                               path + (f,))
                            for f in tree._fields])
    if isinstance(tree, (list, tuple)):
        return type(tree)(tree_map_with_path(fn, v, path + (i,))
                          for i, v in enumerate(tree))
    return fn(path, tree)


def flatten_with_path(tree: Any) -> Dict[tuple, Any]:
    """``{path: leaf}`` of a tree, leaves in tree order.  A spec (a tuple
    of axis entries) is a leaf."""
    out: Dict[tuple, Any] = {}

    def walk(t, path):
        if isinstance(t, dict):
            for k, v in t.items():
                walk(v, path + (k,))
        elif isinstance(t, tuple) and hasattr(t, "_fields"):
            for f in t._fields:
                walk(getattr(t, f), path + (f,))
        elif isinstance(t, list):
            for i, v in enumerate(t):
                walk(v, path + (i,))
        else:
            out[path] = t

    walk(tree, ())
    return out


def _meta(t: torch.Tensor, shape=None) -> torch.Tensor:
    return torch.empty(tuple(t.shape) if shape is None else shape,
                       dtype=t.dtype, device="meta")


def _nest(named: Dict[str, torch.Tensor]) -> Any:
    """Dotted names -> nested dicts, digit components as list indices."""
    root: dict = {}
    for name, t in named.items():
        node = root
        parts = name.split(".")
        for p in parts[:-1]:
            node = node.setdefault(p, {})
        node[parts[-1]] = t

    def listify(node):
        if not isinstance(node, dict):
            return node
        out = {k: listify(v) for k, v in node.items()}
        if out and all(k.isdigit() for k in out):
            return [out[str(i)] for i in range(len(out))]
        return out

    return listify(root)


def _stack(layers: list) -> Any:
    """Per-layer trees of equal structure -> one tree of ``[L, ...]`` meta
    stacks (the reference's scanned layout)."""
    first = layers[0]

    def one(path, leaf):
        shapes = {tuple(flatten_with_path(lay)[path].shape)
                  for lay in layers}
        if len(shapes) != 1:
            raise ValueError(f"layer leaf {path} differs in shape across "
                             f"layers {sorted(shapes)}: cannot stack")
        return _meta(leaf, (len(layers),) + tuple(leaf.shape))

    return tree_map_with_path(one, first)


def named_params(params) -> Dict[str, torch.Tensor]:
    """``{name: tensor}`` of a module's parameters (or the mapping
    itself)."""
    if isinstance(params, torch.nn.Module):
        return dict(params.named_parameters())
    return dict(params)


def param_tree(params, cfg: ModelConfig) -> Any:
    """The parameters of a port module (or its ``{name: tensor}``) as the
    reference's pytree of meta tensors (``jax.eval_shape(model.init)``):
    nested by attribute names, the blocks stacked ``[L, ...]`` under
    ``cfg.scan_layers``."""
    tree = _nest({k: _meta(v) for k, v in named_params(params).items()})
    if cfg.scan_layers and isinstance(tree.get("blocks"), list):
        tree["blocks"] = _stack(tree["blocks"])
    return tree


def cache_tree(cache: list, cfg: ModelConfig) -> Any:
    """A port decode cache (one dict per layer) as the reference's
    (stacked ``[L, ...]`` under ``cfg.scan_layers``), meta tensors."""
    layers = tree_map_with_path(lambda _, t: _meta(t), list(cache))
    return _stack(layers) if cfg.scan_layers else layers


# the reference's tables -----------------------------------------------------

_MOE_TABLE = {
    "router": (None, None),
    "w_gate": ("__ep__", None, "model"),
    "w_up": ("__ep__", None, "model"),
    "w_down": ("__ep__", "model", None),
}

_PARAM_TABLE = {
    # embeddings / heads
    "embed": ("model", None),
    "lm_head": (None, "model"),
    "enc_pos": (None, None),
    "dec_pos": (None, None),
    # attention
    "wq": (None, "model"),
    "wk": (None, "model"),
    "wv": (None, "model"),
    "wo": ("model", None),
    "q_norm": (None,),
    "k_norm": (None,),
    # dense mlp
    "w_gate": (None, "model"),
    "w_up": (None, "model"),
    "w_down": ("model", None),
    "b_up": ("model",),
    "b_down": (None,),
    # xlstm
    "wif": (None, "model"),
    "wz": (None, "model"),
    "w": (None, "model"),
    "r": (None, "model"),
    # mamba
    "in_proj": (None, "model"),
    "out_proj": ("model", None),
    "conv_w": (None, "model"),
    "a_log": ("model", None),
    "d_skip": ("model",),
    "wb": ("model", None),
    "wc": ("model", None),
    "w_dt": ("model", None),
    "w_dt2": (None, "model"),
    "dt_bias": ("model",),
    # norms
    "scale": (None,),
    "bias": (None,),
}

_CACHE_TABLE = {
    # [*, B, phys, K, dh]
    "k": ("__dp__", None, None, "model"),
    "v": ("__dp__", None, None, "model"),
    "xk": ("__dp__", None, None, "model"),
    "xv": ("__dp__", None, None, "model"),
    # mlstm state
    "C": ("__dp__", None, None, "model"),
    "n": ("__dp__", None, "model"),
    "m": ("__dp__", None),
    # slstm state
    "c": ("__dp__", "model"),
    "h": ("__dp__", "model", None),   # also mamba h [B, d_in, N]
    # mamba conv window [B, K-1, d_in]
    "conv": ("__dp__", None, "model"),
}

# slstm n/h/m collide with mlstm names at different ranks; rank disambiguates.
_CACHE_BY_RANK = {
    ("n", 2): ("__dp__", "model"),
    ("h", 2): ("__dp__", "model"),
    ("m", 1): ("__dp__",),
    ("m", 2): ("__dp__", None),
}


def _resolve(entry, ep, dp):
    return tuple(ep if e == "__ep__" else dp if e == "__dp__" else e
                 for e in entry)


def _axis_size(mesh, entry) -> int:
    return 1 if entry is None else mesh.axis_size(entry)


def _drop_uneven(mesh, entry: tuple, shape: tuple) -> tuple:
    """Replicate dims that the assigned axes do not divide (odd vocab
    sizes, batch=1 decode, 14-head attention on a 16-way TP axis, ...), as
    the reference does for jit's even-divisibility rule."""
    return tuple(None if e is not None and dim % _axis_size(mesh, e)
                 else e for dim, e in zip(shape, entry))


def _name(path: tuple) -> str:
    """The last dict key of a path (the reference skips list indices)."""
    for part in reversed(path):
        if isinstance(part, str):
            return part
    return ""


def _path_str(path: tuple) -> str:
    return "/".join(str(p) for p in path)


def _trailing_spec(name: str, ndim: int, path: str, ep, dp) -> Spec:
    in_moe = "/moe/" in path or path.endswith("moe")
    table = dict(_PARAM_TABLE)
    if in_moe:
        table.update(_MOE_TABLE)
    entry = table.get(name)
    if entry is None:
        return ()  # replicate unknown leaves
    entry = _resolve(entry, ep, dp)
    if len(entry) > ndim:
        entry = entry[len(entry) - ndim:]
    return (None,) * (ndim - len(entry)) + tuple(entry)


def param_specs(cfg: ModelConfig, mesh, params_shape) -> Any:
    """Tree of specs matching a params tree (the reference's
    ``param_shardings``)."""
    ep_axes = choose_ep_axes(cfg, mesh)
    ep = None if ep_axes is None else \
        (ep_axes if len(ep_axes) > 1 else ep_axes[0])
    dp = tuple(a for a in mesh.axis_names if a != "model")

    def one(path, leaf):
        shape = tuple(leaf.shape)
        entry = _trailing_spec(_name(path), len(shape), _path_str(path),
                               ep, dp)
        if cfg.pure_dp:  # small models: replicate weights, no TP
            entry = tuple(None if e == "model" else e for e in entry)
        if cfg.fsdp and len(shape) >= 2:
            # ZeRO-3 over the intra-pod DP axes on the first free, evenly
            # divisible dim; never over the pod axis (the reference's rule)
            fsdp_dp = tuple(a for a in mesh.axis_names if a != "pod") \
                if cfg.pure_dp else (tuple(a for a in dp if a != "pod")
                                     or dp)
            fsdp_entry = fsdp_dp if len(fsdp_dp) > 1 else fsdp_dp[0]
            used = {a for e in entry if e
                    for a in ((e,) if isinstance(e, str) else e)}
            if not used & set(fsdp_dp):
                for i, (e, dim) in enumerate(zip(entry, shape)):
                    if e is None and dim % _axis_size(mesh, fsdp_entry) == 0:
                        entry = entry[:i] + (fsdp_entry,) + entry[i + 1:]
                        break
        return _drop_uneven(mesh, entry, shape)

    return tree_map_with_path(one, params_shape)


def cache_specs(cfg: ModelConfig, mesh, cache_shape) -> Any:
    """Tree of specs matching a decode-cache tree (the reference's
    ``cache_shardings``)."""
    del cfg
    dp = tuple(a for a in mesh.axis_names if a != "model")
    dp_entry = dp if len(dp) > 1 else dp[0]

    def one(path, leaf):
        name, ndim = _name(path), len(leaf.shape)
        # strip the scan-stacked layer dim if present
        entry = _CACHE_BY_RANK.get((name, ndim)) \
            or _CACHE_BY_RANK.get((name, ndim - 1)) \
            or _CACHE_TABLE.get(name)
        if entry is None:
            return ()
        entry = _resolve(entry, None, dp_entry)
        if len(entry) > ndim:
            entry = entry[len(entry) - ndim:]
        pad = (None,) * (ndim - len(entry))
        return _drop_uneven(mesh, pad + tuple(entry), tuple(leaf.shape))

    return tree_map_with_path(one, cache_shape)


def batch_specs(mesh, batch_shape, pure_dp: bool = False) -> Any:
    """Tree of specs matching a batch tree (the reference's
    ``batch_shardings``): the leading dim over the DP axes."""
    dp = tuple(mesh.axis_names) if pure_dp \
        else tuple(a for a in mesh.axis_names if a != "model")
    dp_entry = dp if len(dp) > 1 else dp[0]

    def one(path, leaf):
        ndim = len(leaf.shape)
        if ndim == 0:
            return ()
        return _drop_uneven(mesh, (dp_entry,) + (None,) * (ndim - 1),
                            tuple(leaf.shape))

    return tree_map_with_path(one, batch_shape)


def state_specs(cfg: ModelConfig, mesh, state_shape) -> Any:
    """TrainState = {params, opt(m, v, count), step}: moments follow params
    (the reference's ``state_shardings``)."""
    opt = state_shape["opt"]
    return {"params": param_specs(cfg, mesh, state_shape["params"]),
            "opt": type(opt)(m=param_specs(cfg, mesh, opt.m),
                             v=param_specs(cfg, mesh, opt.v), count=()),
            "step": ()}


def spec_tree(specs: Any) -> Any:
    """The reference's ``spec_tree`` maps shardings to their specs; the
    port's spec trees are already that, so this returns its argument."""
    return specs


def module_specs(cfg: ModelConfig, mesh, params) -> Dict[str, Spec]:
    """``{parameter name: spec}`` for a port module's own (per-layer)
    parameters (or its ``{name: tensor}``): ``param_specs`` of its
    reference-layout tree, a scanned stack's spec without its layer entry.
    Under FSDP, where the reference's rule shards a scanned stack's layer
    axis (its first free dim), per-layer modules apply the rule to each
    layer's own leaf instead: ``param_specs`` of the unscanned config
    (each process holds ``1 / D`` of every layer, the reference's bytes)."""
    if cfg.fsdp:
        cfg = dataclasses.replace(cfg, scan_layers=False)
    flat = flatten_with_path(param_specs(cfg, mesh, param_tree(params, cfg)))
    out = {}
    for name in named_params(params):
        path = tuple(int(p) if p.isdigit() else p for p in name.split("."))
        if cfg.scan_layers and path[0] == "blocks":
            # without FSDP no rule gives the layer axis an entry
            spec = flat[("blocks",) + path[2:]][1:]
        else:
            spec = flat[path]
        out[name] = spec
    return out


_FSDP_LAYOUTS: Dict[tuple, Dict[str, Tuple[int, Tuple[str, ...]]]] = {}


def fsdp_layout(cfg: ModelConfig, mesh
                ) -> Dict[str, Tuple[int, Tuple[str, ...]]]:
    """``{parameter name: (dim, axes)}`` of every leaf that FSDP stores
    sliced over ``axes`` (of size above 1) along ``dim`` on ``mesh``: the
    entry ``module_specs`` adds with ``cfg.fsdp`` (``models/fsdp.py``
    gathers these); empty without FSDP."""
    if not cfg.fsdp:
        return {}
    key = (cfg, tuple(mesh.shape), tuple(mesh.axis_names))
    got = _FSDP_LAYOUTS.get(key)
    if got is None:
        from ..models import build_model

        module = build_model(cfg, "meta").init(torch.Generator())
        with_ = module_specs(cfg, mesh, module)
        without = module_specs(dataclasses.replace(cfg, fsdp=False), mesh,
                               module)
        got = {}
        for name, spec in with_.items():
            for dim, (a, b) in enumerate(zip(spec, without[name])):
                if a != b and mesh.axis_size(_axes(a)) > 1:
                    got[name] = (dim, _axes(a))
        _FSDP_LAYOUTS[key] = got
    return got


# shards ---------------------------------------------------------------------

def _axes(entry) -> Tuple[str, ...]:
    return () if entry is None else \
        ((entry,) if isinstance(entry, str) else tuple(entry))


def sharded_axes(mesh, spec: Spec) -> Tuple[str, ...]:
    """The axes of ``mesh`` (in mesh order, each of size above 1) that
    ``spec`` shards over: the ranks along them hold different slices."""
    used = {a for e in spec for a in _axes(e)}
    return tuple(a for a in mesh.axis_names
                 if a in used and mesh.axis_size(a) > 1)


def _slices(shape, spec: Spec, mesh, coords) -> tuple:
    """Per dim, the slice that the rank at ``coords`` (one coordinate per
    mesh axis) holds under ``spec``."""
    where = dict(zip(mesh.axis_names, (int(c) for c in coords)))
    out = []
    for i, dim in enumerate(shape):
        axes = _axes(spec[i] if i < len(spec) else None)
        if not axes:
            out.append(slice(None))
            continue
        n = mesh.axis_size(axes)
        if dim % n:
            raise ValueError(f"dim {i} of size {dim} does not split {n} "
                             f"ways over {axes}")
        j = 0
        for a in axes:
            j = j * mesh.axis_size(a) + where[a]
        step = dim // n
        out.append(slice(j * step, (j + 1) * step))
    return tuple(out)


def shard_tensor(full, spec: Spec, mesh, coords=None):
    """The slice of ``full`` (a tensor or numpy array) held by the rank at
    ``coords`` (one coordinate per mesh axis; default: this process's, on a
    ``ProcessMesh``).  A view: ``clone`` it to drop the whole."""
    if coords is None:
        if not isinstance(mesh, ProcessMesh):
            raise ValueError("shard_tensor on a LocalMesh needs coords")
        coords = mesh.rank_coords
    return full[_slices(tuple(full.shape), spec, mesh, coords)]


def gather_tensor(local: torch.Tensor, spec: Spec, mesh,
                  out_device=None) -> torch.Tensor:
    """The whole tensor from the shards of ``spec``, the inverse of
    ``shard_tensor``, on ``out_device`` (default: ``local``'s).  On a
    ``ProcessMesh`` ``local`` is this process's shard and the call is
    collective over the spec's axes' group (every member gets the whole;
    ``launch/mesh.all_gather``); on a ``LocalMesh`` it is every rank's
    shard stacked ``[R, ...]``."""
    used = [a for a in mesh.axis_names
            if any(a in _axes(e) for e in spec)]
    if isinstance(mesh, ProcessMesh):
        if not used:
            return local if out_device is None else local.to(out_device)
        parts = all_gather(mesh, local[None], tuple(used), out_device)[0]
        sizes = [mesh.axis_size(a) for a in used]
        mine = dict(zip(mesh.axis_names, mesh.rank_coords))
        coords = []
        for j in range(parts.shape[0]):
            c = dict(mine, **{a: int(v) for a, v in
                              zip(used, np.unravel_index(j, sizes))})
            coords.append([c[a] for a in mesh.axis_names])
    else:
        parts = local if out_device is None else local.to(out_device)
        coords = mesh.coords().tolist()
    shape = list(parts.shape[1:])
    for i, e in enumerate(spec):
        shape[i] *= _axis_size(mesh, e) if e is not None else 1
    out = parts.new_empty(shape)
    for part, c in zip(parts, coords):
        out[_slices(shape, spec, mesh, c)] = part
    return out


def whole_kv_heads(parts, cfg: ModelConfig):
    """A decode cache's whole keys or values ``[B, S_phys, K, Dh]`` from the
    model peers' ``[B, S_phys, K_sel, Dh]`` (``parts``, by model
    coordinate): each kv head from the first peer that reads it
    (``tp.kv_heads``).  Raises when its replicas on the peers that share it
    are not bit for bit the same.  ``parts`` of one layer's cache dicts
    (``{"k", "v"}``, an encoder-decoder's cross ``{"xk", "xv"}`` too) give
    the dict of whole tensors."""
    if isinstance(parts[0], dict):
        return {key: whole_kv_heads([p[key] for p in parts], cfg)
                for key in parts[0]}
    n = len(parts)
    whole = [None] * cfg.n_kv_heads
    for coord, part in enumerate(parts):
        sel = kv_heads(cfg.n_heads, cfg.n_kv_heads, n, coord)
        if part.shape[2] != len(sel):
            raise ValueError(f"model coordinate {coord} holds "
                             f"{part.shape[2]} kv heads; it reads {sel}")
        for j, head in enumerate(sel):
            t = part[:, :, j]
            if whole[head] is None:
                whole[head] = t
            elif not torch.equal(whole[head], t):
                raise ValueError(f"the replicas of kv head {head} differ "
                                 f"on model coordinate {coord}")
    return torch.stack(whole, 2)


def _same(a: torch.Tensor, b: torch.Tensor, what: str) -> torch.Tensor:
    if not torch.equal(a, b):
        raise ValueError(f"the replicas of {what} differ")
    return a


def _whole_mlstm(parts, cfg: ModelConfig) -> dict:
    """The mLSTM's whole ``C [B, H, dh, dh]``, ``n`` and ``m`` from the
    model peers' touched heads (``models/ssm.py``)."""
    h, d = cfg.n_heads, cfg.d_model
    dh, cols = d // h, d // len(parts)
    c0 = parts[0]["C"]
    whole = {"C": c0.new_zeros((c0.shape[0], h, dh, dh)), "n": [None] * h,
             "m": [None] * h}
    for coord, part in enumerate(parts):
        heads, off = q_heads(h, dh, cols, coord)
        for j, head in enumerate(heads):
            # this coordinate's columns [off, off + cols) of its heads' dh
            # each, those of head ``head`` within it
            lo, hi = max(off, j * dh), min(off + cols, (j + 1) * dh)
            src = (lo - off, hi - off) if len(heads) == 1 else \
                (lo - j * dh, hi - j * dh)
            whole["C"][:, head, :, lo - j * dh:hi - j * dh] = \
                part["C"][:, j, :, src[0]:src[1]]
            for key in ("n", "m"):
                t = part[key][:, j]
                whole[key][head] = t if whole[key][head] is None else \
                    _same(whole[key][head], t, f"{key} of head {head}")
    return {"C": whole["C"], "n": torch.stack(whole["n"], 1),
            "m": torch.stack(whole["m"], 1)}


def whole_states(parts, cfg: ModelConfig):
    """A layer's whole decode state from the model peers' (``parts``, by
    model coordinate; ``models/ssm.py``): Mamba's ``{"h", "conv"}`` and the
    sLSTM's ``{"c", "n", "h", "m"}`` joined by channel, the mLSTM's
    ``{"C", "n", "m"}`` by head (raises where two replicas of a head's
    ``n`` or ``m`` differ).  ``parts`` of one layer's cache dicts give the
    whole dict: ``{"state"}``, or a hybrid layer's ``{"k", "v", "ssm"}``
    (its keys and values by ``whole_kv_heads``)."""
    first = parts[0]
    if "state" in first or "ssm" in first:
        out = {}
        for key in first:
            got = [p[key] for p in parts]
            out[key] = whole_states(got, cfg) if key in ("state", "ssm") \
                else whole_kv_heads(got, cfg)
        return out
    if "C" in first:
        return _whole_mlstm(parts, cfg)
    dims = {"h": 1, "conv": 2} if "conv" in first else \
        {k: 1 for k in first}
    return {k: torch.cat([p[k] for p in parts], dim) for k, dim in
            dims.items()}
