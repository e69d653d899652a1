"""The port's dry run (``repro_torch.launch.dryrun``) against the
reference's (``repro.launch.dryrun``), and against real processes.

* Key parity: on the smoke cells of ``tests/test_dryrun_small.py`` (the
  same small configs, the ``(2, 2, 4)`` mesh) the port's ``run_cell`` gives
  the reference's ``params_total``, ``params_active``,
  ``model_flops_total``, ``model_flops_per_chip`` and ``n_chips``, exactly,
  and its rank's parameter bytes are the sum of the reference's
  ``NamedSharding.shard_shape`` bytes under the reference's specs.  The
  per-chip FLOPs and bytes and the collective bytes are printed beside the
  reference's ``cost_analysis`` and ``parse_collectives`` figures, not
  gated: XLA counts elementwise FLOPs and fuses ops, the port counts the
  products alone and every op's operands, and its layouts differ
  (ROADMAP.md, Queue 3).
* Rank 0 of 4 gloo processes on ``(2, 2, 1)``, running the smoke MoE cell
  under ``count()``, reports the FLOPs, bytes and collectives by op and tier
  that the dry run of the same cell and mesh counts, exactly (the cell has
  a ``pod`` axis, so both tiers appear); a kernel wrapper that does not
  report in the processes alone breaks it.

The reference runs once, in one subprocess on 16 fake devices.
"""

import contextlib
import json
import sys

import pytest
import torch
from conftest import run_subprocess

from repro_torch.configs import smoke_config
from repro_torch.launch.dryrun import dry_counts, rank_program, run_cell
from repro_torch.launch.procs import spawn
from repro_torch.launch.roofline import count

CELLS = [("qwen3-0.6b", "train_4k"), ("mixtral-8x7b", "train_4k"),
         ("xlstm-125m", "decode_32k")]
MESH = (2, 2, 4)

_REF = """
import os, json
os.environ["TF_CPP_MIN_LOG_LEVEL"] = "3"
import dataclasses as dc
import numpy as np
import jax
from repro.configs import get_config, SHAPES
from repro.configs.registry import MoESpec
import repro.configs.registry as reg
from repro.launch.mesh import make_mesh
import repro.launch.mesh as mesh_mod
mesh_mod.make_production_mesh = \\
    lambda multi_pod=False: make_mesh((2, 2, 4), ("pod", "data", "model"))
import repro.launch.dryrun as dr
from repro.launch.train import make_train_state_shapes

out = {}
for arch, shape_name in CELLS:
    cfg = get_config(arch)
    small = dc.replace(cfg, n_layers=2, scan_layers=False, d_model=256,
                       d_ff=512, n_heads=8, n_kv_heads=4, head_dim=32,
                       vocab=3200)
    if small.moe:
        small = dc.replace(small, moe=MoESpec(num_experts=4, top_k=2))
    if small.block_pattern:
        small = dc.replace(small, block_pattern=("m", "s"))
    reg._REGISTRY[arch] = lambda small=small: small
    shape = dc.replace(SHAPES[shape_name], global_batch=16,
                       seq_len=min(SHAPES[shape_name].seq_len, 512))
    dr.SHAPES = dict(SHAPES)
    dr.SHAPES[shape_name] = shape
    res = dr.run_cell(arch, shape_name, "multi")
    assert res["status"] == "ok", res.get("error")
    mesh = make_mesh((2, 2, 4), ("pod", "data", "model"))
    state, sh = make_train_state_shapes(small, mesh)
    leaves = jax.tree.leaves(state["params"])
    shards = jax.tree.leaves(sh["params"])
    res["param_shard_bytes"] = int(sum(
        int(np.prod(s.shard_shape(l.shape))) * l.dtype.itemsize
        for l, s in zip(leaves, shards)))
    out[arch + "|" + shape_name] = res
with open(OUT, "w") as f:
    json.dump(out, f)
print("REF_OK")
"""


def _small(arch):
    import dataclasses as dc

    from repro_torch.configs import SHAPES, get_config
    from repro_torch.configs.registry import MoESpec

    cfg = get_config(arch)
    small = dc.replace(cfg, n_layers=2, scan_layers=False, d_model=256,
                       d_ff=512, n_heads=8, n_kv_heads=4, head_dim=32,
                       vocab=3200)
    if small.moe:
        small = dc.replace(small, moe=MoESpec(num_experts=4, top_k=2))
    if small.block_pattern:
        small = dc.replace(small, block_pattern=("m", "s"))
    return small, SHAPES


@pytest.fixture(scope="module")
def ref(tmp_path_factory):
    path = str(tmp_path_factory.mktemp("dryrun") / "ref.json")
    out = run_subprocess(f"CELLS = {CELLS!r}\nOUT = {path!r}\n" + _REF,
                         n_devices=16, timeout=900)
    assert "REF_OK" in out
    with open(path) as f:
        return json.load(f)


@pytest.fixture(scope="module")
def ours():
    import dataclasses as dc

    out = {}
    for arch, shape_name in CELLS:
        small, shapes = _small(arch)
        shape = dc.replace(shapes[shape_name], global_batch=16,
                           seq_len=min(shapes[shape_name].seq_len, 512))
        res = run_cell(arch, shape_name, "multi", cfg=small, shape=shape,
                       mesh_shape=MESH)
        assert res["status"] == "ok", res.get("traceback")
        out[arch + "|" + shape_name] = res
    return out


KEYS = ("params_total", "params_active", "model_flops_total",
        "model_flops_per_chip", "n_chips")


@pytest.mark.parametrize("cell", [f"{a}|{s}" for a, s in CELLS])
@pytest.mark.parametrize("key", KEYS)
def test_key_equals_the_reference(ref, ours, cell, key):
    assert ours[cell][key] == ref[cell][key]


@pytest.mark.parametrize("cell", [f"{a}|{s}" for a, s in CELLS
                                  if s == "train_4k"])
def test_rank_parameter_bytes_are_the_reference_shard_bytes(ref, ours, cell):
    """The train state's parameters (f32 masters in both packages)."""
    assert ours[cell]["memory"]["param_bytes"] == \
        ref[cell]["param_shard_bytes"]


@pytest.mark.parametrize("cell", [f"{a}|{s}" for a, s in CELLS])
def test_reference_keys_side_by_side(ref, ours, cell):
    """Every key of the reference's result is in the port's; the counted
    figures are printed beside the reference's (not gated)."""
    r, o = ref[cell], ours[cell]
    assert set(r) - {"param_shard_bytes"} <= set(o)
    assert set(r["memory"]) <= set(o["memory"])
    assert set(r["roofline"]) == set(o["roofline"])
    assert o["compile_s"] is None and o["cost_source"] == "direct"
    assert o["memory"]["temp_bytes"] is None
    assert o["flops_per_chip"] > 0 and o["bytes_per_chip"] > 0
    # the port counts the products (and attention) alone; XLA every op
    assert o["flops_per_chip"] >= o["model_flops_per_chip"] * 0.9
    print(f"\n{cell} per chip: FLOPs {o['flops_per_chip']:.4e} (reference "
          f"{r['flops_per_chip']:.4e}), bytes {o['bytes_per_chip']:.4e} "
          f"({r['bytes_per_chip']:.4e}), collective wire bytes ici "
          f"{o['collectives']['ici_bytes']:.4e} "
          f"({r['collectives']['ici_bytes']:.4e}) "
          f"dcn {o['collectives']['dcn_bytes']:.4e} "
          f"({r['collectives']['dcn_bytes']:.4e}); by op "
          f"{o['collectives']['by_op']} (reference "
          f"{r['collectives']['by_op']})")


# -- rank 0 of real processes against the dry run ------------------------------

AXES = ("pod", "data", "model")
PROC_MESH = (2, 2, 1)
PROC_CELLS = {"train": ("train", None), "plan prefill": ("prefill", "plan")}


@contextlib.contextmanager
def _unreported(name):
    """A planted fault: ``name``'s wrapper neither reports nor hides its
    own work (``grouped_matmul``'s module)."""
    module = sys.modules["repro_torch.kernels.grouped_matmul.grouped_matmul"]
    real = module._counted
    module._counted = lambda kernel, cost: contextlib.nullcontext() \
        if kernel == name else real(kernel, cost)
    try:
        yield
    finally:
        module._counted = real


def _counted_rank(mesh, cfg, kind, impl, plan, fault):
    torch.set_num_threads(1)
    run, memory = rank_program(cfg, kind, 16, 8, mesh, impl, plan)
    with (_unreported("grouped_matmul") if fault
          else contextlib.nullcontext()), count() as c:
        run()
    return {"rank": mesh.rank, "counts": c.summary(), "memory": memory}


@pytest.fixture(scope="module")
def procs(tmp_path_factory):
    from repro_torch.launch.dryrun import _plan_for
    from repro_torch.launch.mesh import dry_mesh

    cfg = smoke_config("megatron-moe-32e")
    out = {}
    for name, (kind, impl) in PROC_CELLS.items():
        plan = _plan_for(cfg, dry_mesh(PROC_MESH, AXES), impl)
        for fault in (False, True):
            if fault and name != "plan prefill":
                continue
            rdv = tmp_path_factory.mktemp("rdv") / "store"
            ranks = spawn(_counted_rank, PROC_MESH, AXES, "gloo", "cpu", cfg,
                          kind, impl, plan, fault,
                          init_method=f"file://{rdv}", timeout=60.0,
                          join_timeout=300)
            got = next(r for r in ranks if r["rank"] == 0)
            want, memory = dry_counts(cfg, kind, 16, 8, PROC_MESH, AXES,
                                      impl, plan)
            out[(name, fault)] = (got, want.summary(), memory)
    return out


@pytest.mark.parametrize("cell", list(PROC_CELLS))
def test_rank0_collectives_equal_the_dry_run(procs, cell):
    got, want, _ = procs[(cell, False)]
    g, w = got["counts"]["collectives"], want["collectives"]
    assert g == w
    tiers = {t for by in w["by_tier"].values() for t, v in by.items() if v}
    assert tiers == {"ici", "dcn"}


@pytest.mark.parametrize("cell", list(PROC_CELLS))
def test_rank0_flops_and_bytes_equal_the_dry_run(procs, cell):
    got, want, memory = procs[(cell, False)]
    assert (got["counts"]["flops"], got["counts"]["bytes"],
            got["counts"]["kernels"]) == (want["flops"], want["bytes"],
                                          want["kernels"])
    assert got["memory"] == memory


def test_an_unreported_kernel_in_the_processes_breaks_the_equality(procs):
    got, want, _ = procs[("plan prefill", True)]
    assert "grouped_matmul" in want["kernels"]
    assert "grouped_matmul" not in got["counts"]["kernels"]
    # the plain version's product has the formula's FLOPs on the CPU; its
    # bytes are the plain version's own
    assert (got["counts"]["flops"], got["counts"]["bytes"]) != \
        (want["flops"], want["bytes"])
