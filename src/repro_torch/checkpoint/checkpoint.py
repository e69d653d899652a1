"""Atomic checkpointing of the training state.

Counterpart of ``src/repro/checkpoint/checkpoint.py``, in its step-directory
layout and its atomic commit:

    step_000000123/
      manifest.json       (leaf paths, shapes and dtypes, the step)
      leaves_000.npz ...  (leaf bytes on the host, chunked by size)
      _COMMITTED          (sentinel written last; torn saves are ignored)

A state is a tree of dicts, lists, tuples (``OptState`` included),
``nn.Module``s (saved through their ``state_dict``) and tensors.  Leaves are
saved as raw bytes with their dtype in the manifest (bf16 included) and
restored in place into a target of the same structure, so a restore of the
full-width training state needs no second copy of it on the device.

Saves are mesh-independent, as the reference's: on a ``ProcessMesh`` each
process holds its shard of the tree, and rank 0 writes what a one-process
save of the whole writes, gathering each leaf over the processes that hold
its slices (on the host under gloo), one leaf at a time, while the others
join each gather and then wait until it has committed; a restore there
reads each whole leaf and copies this process's slice into the target.  So
a checkpoint written by processes restores with no mesh or on a
``LocalMesh``, and the reverse.  ``specs`` maps a parameter name, the last
component of a leaf's path (``params/<name>``, ``opt/m/<name>``, ...), to
its spec (``launch/train.train_specs``); other leaves are replicated.
"""

from __future__ import annotations

import json
import os
import shutil
import tempfile
from typing import Any, Dict, List, Optional, Tuple

import numpy as np
import torch
from torch import nn

__all__ = ["save_checkpoint", "restore_checkpoint", "latest_step",
           "available_steps"]

_SENTINEL = "_COMMITTED"
_CHUNK_BYTES = 1 << 30


def _step_dir(root: str, step: int) -> str:
    return os.path.join(root, f"step_{step:09d}")


def _leaves(tree: Any, prefix: str = "") -> List[Tuple[str, torch.Tensor]]:
    """(path, tensor) of every leaf, in a fixed order."""
    if isinstance(tree, nn.Module):
        return [(f"{prefix}{k}", v) for k, v in tree.state_dict().items()]
    if isinstance(tree, dict):
        out = []
        for k in sorted(tree):
            out += _leaves(tree[k], f"{prefix}{k}/")
        return out
    if isinstance(tree, (list, tuple)):
        fields = getattr(tree, "_fields", None)  # a NamedTuple: by name
        out = []
        for i, v in enumerate(tree):
            out += _leaves(v, f"{prefix}{fields[i] if fields else i}/")
        return out
    if isinstance(tree, torch.Tensor):
        return [(prefix.rstrip("/"), tree)]
    raise TypeError(f"cannot checkpoint a {type(tree).__name__} at "
                    f"{prefix!r}")


def _raw(t: torch.Tensor) -> np.ndarray:
    return t.detach().reshape(-1).contiguous().cpu().view(torch.uint8) \
        .numpy()


def _process_mesh(mesh):
    """``mesh`` when its processes hold shards (a ``ProcessMesh``), else
    None: a ``LocalMesh``'s tree is whole."""
    from ..launch.mesh import ProcessMesh

    return mesh if isinstance(mesh, ProcessMesh) else None


def _spec(specs: Optional[Dict[str, tuple]], path: str) -> tuple:
    return (specs or {}).get(path.rsplit("/", 1)[-1], ())


def _whole(t: torch.Tensor, spec: tuple, mesh) -> torch.Tensor:
    """The whole of leaf ``t`` (this process's slice under ``spec``),
    gathered on the host over the processes that hold its slices."""
    from ..launch.shardings import gather_tensor, sharded_axes

    if mesh is None or not sharded_axes(mesh, spec):
        return t
    return gather_tensor(t.detach(), spec, mesh, out_device="cpu")


@torch.no_grad()
def save_checkpoint(root: str, step: int, tree: Any,
                    keep_last: Optional[int] = 3, mesh=None,
                    specs: Optional[Dict[str, tuple]] = None) -> str:
    """Copy ``tree``'s leaves to the host and atomically persist them under
    ``root``.  On a ``ProcessMesh`` (``mesh``, ``specs``) every process
    calls it with its shard; rank 0 writes the whole."""
    mesh = _process_mesh(mesh)
    writer = mesh is None or mesh.rank == 0
    leaves = _leaves(tree)
    tmp = None
    if writer:
        os.makedirs(root, exist_ok=True)
        tmp = tempfile.mkdtemp(dir=root, prefix=".tmp_save_")
    committed = False
    try:
        manifest: Dict[str, Any] = {"step": step, "leaves": [], "files": []}
        buf, size, fidx = {}, 0, 0
        for i, (path, t) in enumerate(leaves):
            whole = _whole(t, _spec(specs, path), mesh)
            if not writer:
                continue
            manifest["leaves"].append(
                {"path": path, "shape": list(whole.shape),
                 "dtype": str(whole.dtype).replace("torch.", "")})
            buf[f"leaf_{i}"] = _raw(whole)
            size += whole.numel() * whole.element_size()
            del whole
            if size >= _CHUNK_BYTES or i == len(leaves) - 1:
                fname = f"leaves_{fidx:03d}.npz"
                np.savez(os.path.join(tmp, fname), **buf)
                manifest["files"].append(fname)
                buf, size, fidx = {}, 0, fidx + 1
        if writer:
            with open(os.path.join(tmp, "manifest.json"), "w") as f:
                json.dump(manifest, f)
            with open(os.path.join(tmp, _SENTINEL), "w") as f:
                f.write("ok")
            final = _step_dir(root, step)
            if os.path.exists(final):
                shutil.rmtree(final)
            os.rename(tmp, final)
            committed = True
    finally:
        # the original exception propagates untouched; the staging dir is
        # removed on every exit that did not commit
        if writer and not committed:
            shutil.rmtree(tmp, ignore_errors=True)
    if writer and keep_last is not None:
        _gc(root, keep_last)
    if mesh is not None:
        from ..launch.mesh import all_ranks

        all_ranks(mesh, 0)  # the others return once rank 0 has committed
    return _step_dir(root, step)


def _gc(root: str, keep_last: int) -> None:
    steps = available_steps(root)
    for s in steps[:-keep_last]:
        shutil.rmtree(_step_dir(root, s), ignore_errors=True)


def available_steps(root: str):
    if not os.path.isdir(root):
        return []
    steps = []
    for name in os.listdir(root):
        if name.startswith("step_") and os.path.exists(
                os.path.join(root, name, _SENTINEL)):
            steps.append(int(name.split("_")[1]))
    return sorted(steps)


def latest_step(root: str) -> Optional[int]:
    steps = available_steps(root)
    return steps[-1] if steps else None


@torch.no_grad()
def restore_checkpoint(root: str, target: Any, step: Optional[int] = None,
                       mesh=None, specs: Optional[Dict[str, tuple]] = None
                       ) -> Tuple[Any, int]:
    """Restore into ``target`` (a tree of the saved structure), in place.
    Returns (target, step).  Leaf paths and shapes must match; values are
    cast to each target leaf's dtype.  On a ``ProcessMesh`` (``mesh``,
    ``specs``) ``target`` is this process's shard, and each leaf's slice is
    cut from the whole read from disk."""
    from ..launch.shardings import shard_tensor

    mesh = _process_mesh(mesh)
    if step is None:
        step = latest_step(root)
        if step is None:
            raise FileNotFoundError(f"no committed checkpoints under {root}")
    d = _step_dir(root, step)
    with open(os.path.join(d, "manifest.json")) as f:
        manifest = json.load(f)
    leaves = _leaves(target)
    if [p for p, _ in leaves] != [m["path"] for m in manifest["leaves"]]:
        raise ValueError("checkpoint leaves do not match the target's")
    files = [np.load(os.path.join(d, fname)) for fname in manifest["files"]]
    try:
        where = {k: z for z in files for k in z.files}
        for i, ((path, t), meta) in enumerate(zip(leaves,
                                                  manifest["leaves"])):
            raw = torch.from_numpy(where[f"leaf_{i}"][f"leaf_{i}"].copy())
            value = raw.view(getattr(torch, meta["dtype"])).reshape(
                meta["shape"])
            if mesh is not None:
                value = shard_tensor(value, _spec(specs, path), mesh)
            if tuple(value.shape) != tuple(t.shape):
                raise ValueError(f"checkpoint leaf {path} shape "
                                 f"{tuple(value.shape)} != target "
                                 f"{tuple(t.shape)}")
            t.copy_(value)
    finally:
        for z in files:
            z.close()
    return target, step
