"""Dry run: one rank's program of every (arch x shape x mesh) cell, at the
published widths, on meta tensors.

Counterpart of ``src/repro/launch/dryrun.py``, which lowers and compiles
each cell on 512 fake devices and records XLA's memory and cost analysis.
The port has no compiler to ask, so it runs the program itself: rank 0's
of the production mesh

    single pod : (16, 16)        ("data", "model")       256 ranks
    multi-pod  : (2, 16, 16)     ("pod", "data", "model") 512 ranks

on ``launch/mesh.dry_mesh``, a ``ProcessMesh`` with no world whose
collectives return empty meta tensors, so no memory is taken and no other
process runs.  For each cell it

  1. cuts this rank's shard of the published model on meta tensors
     (``convert.shard_module``) and its rows of the batch,
  2. runs the step once under ``roofline.count()``: the train step of
     ``launch/train.py`` (loss, backward, the gradient sync, AdamW), or the
     prefill or decode step of ``launch/serve.py``, through the cell's MoE
     exchange (``--a2a plan`` synthesizes the FAST plan for the mesh),
  3. writes the reference's keys: the inputs' and outputs' bytes from the
     meta tensors, the counted FLOPs, bytes and collectives by op and tier,
     the roofline terms on an H100 (``roofline.HW``), and the model FLOPs
     of the config.

Keys with no meaning here are ``null``: ``compile_s``, and ``temp_bytes``
and ``peak_bytes`` (meta tensors hold nothing).  ``cost_source`` is
``"direct"``: the port runs every layer, so the reference's 2/3-layer
extrapolation of a scanned stack has no counterpart.  The drivers' host
loops (``serve_procs``, ``train_procs``) are not run: only the steps.

Usage:
    PYTHONPATH=src python -m repro_torch.launch.dryrun \\
        --arch mixtral-8x7b --shape prefill_32k --mesh multi --a2a plan
    PYTHONPATH=src python -m repro_torch.launch.dryrun --all --mesh multi
"""

from __future__ import annotations

import argparse
import ast
import dataclasses
import json
import os
import time
import traceback
from typing import Dict, Optional, Tuple

import numpy as np
import torch

from ..configs import SHAPES, get_config, list_archs, skip_reason
from .mesh import dry_mesh, make_production_mesh
from .roofline import HW, Counts, count, roofline_terms

__all__ = ["rank_program", "dry_counts", "run_cell", "main"]

OUT_DIR = "dryrun_out"


def _tensor_bytes(tree) -> int:
    from torch.utils._pytree import tree_flatten

    leaves = tree_flatten(tree)[0]
    return sum(t.numel() * t.element_size() for t in leaves
               if isinstance(t, torch.Tensor))


def _module_bytes(module: torch.nn.Module) -> int:
    return sum(p.numel() * p.element_size() for p in module.parameters())


def _plan_for(cfg, mesh, impl: Optional[str]):
    if impl != "plan" or cfg.moe is None:
        return None
    from .serve import flash_plan

    pod = mesh.axis_size("pod") if "pod" in mesh.axis_names else 1
    return flash_plan(pod, mesh.axis_size("data"))


def rank_program(cfg, kind: str, seq_len: int, global_batch: int, mesh,
                 a2a_impl: Optional[str] = None, plan=None,
                 microbatches: int = 1, cache_len: Optional[int] = None):
    """This rank's program of one cell on ``mesh`` (a ``ProcessMesh``:
    ``dry_mesh`` for the dry run, a joined one to count a real rank the
    same way): returns ``(run, memory)``, ``run()`` taking the step once
    and returning its outputs, ``memory`` the parameter, argument and
    output bytes.

    ``kind`` is ``train`` (the global batch ``[global_batch, seq_len]``,
    ``microbatches`` of it), ``prefill`` (this rank's prompts of
    ``seq_len`` tokens; ``cache_len`` sizes the cache) or ``decode`` (one
    token against a cache of ``seq_len``).  The model is the whole
    published one from seed 0 cut on ``mesh.device`` (meta tensors on a
    dry mesh: no memory), the inputs zeros (what is counted depends on
    shapes alone)."""
    from ..convert import shard_module
    from ..models import build_model, input_specs
    from .shardings import batch_specs, shard_tensor

    train = kind == "train"
    dev = mesh.device
    gen = torch.Generator(device=dev) if dev.type != "meta" \
        else torch.Generator()
    whole = build_model(cfg, dev, train=train).init(gen.manual_seed(0))
    shard = shard_module(whole, cfg, mesh, train=train)
    del whole
    param_bytes = _module_bytes(shard)
    if train:
        from .train import TrainOptions, init_train_state, make_train_step

        state = init_train_state(shard)
        batch = {k: torch.zeros(v.shape, dtype=v.dtype, device=dev)
                 for k, v in input_specs(cfg, "train", seq_len,
                                         global_batch).items()}
        step = make_train_step(cfg, mesh,
                               TrainOptions(microbatches=microbatches))
        args = (state, batch)
        pure = cfg.pure_dp and not cfg.fsdp
        rows = {k: shard_tensor(v, batch_specs(mesh, {k: v},
                                               pure_dp=pure)[k], mesh)
                for k, v in batch.items()}
        arg_bytes = _tensor_bytes((list(state["params"].parameters()),
                                   state["opt"].m, state["opt"].v, rows))
    else:
        from .serve import make_dist_context, make_prefill_step, \
            make_serve_step

        glob = input_specs(cfg, "prefill", seq_len, global_batch)
        glob = {k: v for k, v in glob.items() if k != "labels"}
        # the prompts as ``serve_procs`` holds them: int64 token ids
        glob["tokens"] = torch.empty(glob["tokens"].shape, dtype=torch.int64,
                                     device="meta")
        specs = batch_specs(mesh, glob, pure_dp=cfg.pure_dp and not cfg.fsdp)
        rows = {k: torch.zeros(shard_tensor(v, specs[k], mesh).shape,
                               dtype=v.dtype, device=dev)
                for k, v in glob.items()}
        if kind == "prefill":
            step = make_prefill_step(cfg, mesh, a2a_impl, plan,
                                     cache_len=cache_len, device=dev)
            args = (shard, rows)
            arg_bytes = _tensor_bytes((list(shard.parameters()), rows))
        elif kind == "decode":
            b = rows["tokens"].shape[0]
            model = build_model(cfg, dev)
            dist = make_dist_context(cfg, mesh, a2a_impl, plan)
            if cfg.encdec:
                from ..models.encdec import encdec_init_cache

                # the encoder and the cross K/V: set-up, not the step (a
                # count of its own, since the kernels take meta tensors
                # only while counting)
                with torch.no_grad(), count():
                    cache = encdec_init_cache(cfg, b, seq_len,
                                              rows["frames"], shard,
                                              dist=dist)
            else:
                cache = model.init_cache(b, seq_len, shard, dist)
            step = make_serve_step(cfg, mesh, a2a_impl, plan, device=dev)
            tokens = rows["tokens"][:, 0]
            args = (shard, cache, tokens, seq_len - 1)
            arg_bytes = _tensor_bytes((list(shard.parameters()), cache,
                                       tokens))
        else:
            raise ValueError(f"unknown shape kind {kind!r}")

    memory = {"param_bytes": param_bytes, "argument_bytes": arg_bytes}

    def run():
        out = step(*args)
        memory["output_bytes"] = _tensor_bytes(
            (list(out[0]["params"].parameters()), out[0]["opt"].m,
             out[0]["opt"].v, out[1]) if train else out)
        return out

    return run, memory


def dry_counts(cfg, kind: str, seq_len: int, global_batch: int,
               shape: Tuple[int, ...], axes: Tuple[str, ...],
               a2a_impl: Optional[str] = None, plan=None,
               microbatches: int = 1, cache_len: Optional[int] = None
               ) -> Tuple[Counts, Dict]:
    """``rank_program`` of rank 0 of ``shape`` on a dry mesh, run once
    under ``roofline.count()``: (its counts, its memory)."""
    mesh = dry_mesh(shape, axes)
    run, memory = rank_program(cfg, kind, seq_len, global_batch, mesh,
                               a2a_impl, plan, microbatches, cache_len)
    with count() as c:
        run()
    return c, memory


def _model_flops(cfg, shape) -> float:
    n_active = cfg.n_active_params()
    if shape.kind == "train":
        return 6.0 * n_active * shape.global_batch * shape.seq_len
    if shape.kind == "prefill":
        return 2.0 * n_active * shape.global_batch * shape.seq_len
    return 2.0 * n_active * shape.global_batch


def run_cell(arch: str, shape_name: str, mesh_kind: str,
             a2a_impl: Optional[str] = None,
             overrides: Optional[dict] = None, *, cfg=None, shape=None,
             mesh_shape: Optional[Tuple[int, ...]] = None) -> dict:
    """One cell's dry run, as the reference's ``run_cell``: the config of
    ``arch`` (or ``cfg``) with ``overrides``, the shape ``shape_name`` (or
    ``shape``), rank 0 of the production mesh of ``mesh_kind`` (or of a
    ``(pod, data, model)`` ``mesh_shape``)."""
    cfg = cfg or get_config(arch)
    if overrides:
        overrides = dict(overrides)
        capf = overrides.pop("capacity_factor", None)
        if capf is not None and cfg.moe is not None:
            cfg = dataclasses.replace(cfg, moe=dataclasses.replace(
                cfg.moe, capacity_factor=capf))
        cfg = dataclasses.replace(cfg, **{
            k: v for k, v in overrides.items()
            if k in {f.name for f in dataclasses.fields(cfg)}})
    shape = shape or SHAPES[shape_name]
    reason = skip_reason(cfg, shape)
    if reason:
        return {"arch": arch, "shape": shape_name, "mesh": mesh_kind,
                "status": "skipped", "reason": reason}
    if mesh_shape is None:
        prod = make_production_mesh(multi_pod=(mesh_kind == "multi"),
                                    dry=True)
        mesh_shape, axes = prod.shape, prod.axis_names
    else:
        axes = ("pod", "data", "model")[-len(mesh_shape):]
    n_chips = int(np.prod(mesh_shape))
    impl = a2a_impl or cfg.a2a_impl
    t0 = time.perf_counter()
    try:
        plan = _plan_for(cfg, dry_mesh(mesh_shape, axes), impl)
        c, mem = dry_counts(cfg, shape.kind, shape.seq_len,
                            shape.global_batch, mesh_shape, axes, impl,
                            plan,
                            cfg.microbatches if shape.kind == "train" else 1)
    except Exception as e:  # noqa: BLE001 - reported as cell failure
        return {"arch": arch, "shape": shape_name, "mesh": mesh_kind,
                "status": "failed", "error": f"{type(e).__name__}: {e}",
                "traceback": traceback.format_exc()[-4000:]}
    run_s = time.perf_counter() - t0
    coll = c.collectives
    terms = roofline_terms(c.flops, c.bytes, coll, HW())
    model_flops = _model_flops(cfg, shape)
    return {
        "arch": arch, "shape": shape_name, "mesh": mesh_kind,
        "a2a_impl": impl,
        "overrides": overrides or {},
        "status": "ok",
        "n_chips": n_chips,
        "compile_s": None,
        "run_s": run_s,
        # every layer runs, and the step's own loop runs each microbatch:
        # the count is the step's (the reference scales a scan body that
        # XLA counts once)
        "cost_source": "direct",
        "memory": {
            "argument_bytes": mem["argument_bytes"],
            "output_bytes": mem["output_bytes"],
            "temp_bytes": None,
            "peak_bytes": None,
            "param_bytes": mem["param_bytes"],
        },
        "flops_per_chip": c.flops,
        "bytes_per_chip": c.bytes,
        "kernels": {k: dict(v) for k, v in c.kernels.items()},
        "collectives": {
            "count": coll.count,
            "simple_bytes": coll.simple_bytes,
            "wire_bytes": coll.wire_bytes,
            "ici_bytes": coll.ici_bytes,
            "dcn_bytes": coll.dcn_bytes,
            "by_op": dict(coll.by_op),
            "by_tier": {k: dict(v) for k, v in coll.by_tier.items()},
        },
        "roofline": terms,
        "model_flops_total": model_flops,
        "model_flops_per_chip": model_flops / n_chips,
        "useful_flop_ratio": (model_flops / n_chips) / c.flops
        if c.flops else None,
        "params_total": cfg.n_params(),
        "params_active": cfg.n_active_params(),
    }


def _gb(x):
    return f"{x / (1 << 30):.2f}GB" if x is not None else "?"


def main(argv=None) -> int:
    from ..comm.all_to_all import available_all_to_all_impls

    ap = argparse.ArgumentParser(prog="python -m repro_torch.launch.dryrun")
    ap.add_argument("--arch")
    ap.add_argument("--shape")
    ap.add_argument("--mesh", choices=["single", "multi"], default="single")
    ap.add_argument("--a2a", choices=available_all_to_all_impls())
    ap.add_argument("--all", action="store_true")
    ap.add_argument("--out", default=OUT_DIR,
                    help="directory for JSON results (default: dryrun_out)")
    ap.add_argument("--override", action="append", default=[],
                    help="cfg field overrides key=value (python literals)")
    args = ap.parse_args(argv)

    overrides = {}
    for ov in args.override:
        k, v = ov.split("=", 1)
        try:
            overrides[k] = ast.literal_eval(v)
        except (ValueError, SyntaxError):
            overrides[k] = v

    if args.all:
        cells = [(arch, s) for arch in list_archs() for s in SHAPES]
    else:
        if not args.arch or not args.shape:
            ap.error("--arch/--shape required unless --all")
        cells = [(args.arch, args.shape)]

    failed = 0
    t0 = time.perf_counter()
    for arch, shape_name in cells:
        res = run_cell(arch, shape_name, args.mesh, args.a2a,
                       overrides or None)
        tag = f"{arch}.{shape_name}.{args.mesh}"
        if args.a2a:
            tag += f".{args.a2a}"
        if overrides:
            tag += "." + "_".join(f"{k}-{v}" for k, v in overrides.items())
        print(json.dumps({k: v for k, v in res.items()
                          if k in ("arch", "shape", "mesh", "status",
                                   "run_s", "flops_per_chip", "reason",
                                   "error")}))
        failed += res["status"] == "failed"
        if res["status"] == "ok":
            mem = res["memory"]
            print(f"  memory/chip: params={_gb(mem['param_bytes'])} "
                  f"args={_gb(mem['argument_bytes'])} "
                  f"out={_gb(mem['output_bytes'])}")
            r = res["roofline"]
            print(f"  roofline: compute={r['compute_s']:.4f}s "
                  f"memory={r['memory_s']:.4f}s "
                  f"collective={r['collective_s']:.4f}s "
                  f"dominant={r['dominant']}")
        if args.out:
            os.makedirs(args.out, exist_ok=True)
            with open(os.path.join(args.out, tag + ".json"), "w") as f:
                json.dump(res, f, indent=1)
    print(f"{len(cells)} cell(s), {failed} failed, in "
          f"{time.perf_counter() - t0:.1f} s")
    return 1 if failed else 0


if __name__ == "__main__":
    raise SystemExit(main())
