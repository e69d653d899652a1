"""The port's roofline (``repro_torch.launch.roofline``) against the
reference's (``repro.launch.roofline``), and its counter.

* ``roofline_terms`` gives the reference's dict on the reference's inputs
  and constants (``tests/test_roofline.py``'s cases and more); the wire
  bytes of every op and group size are the reference's.
* The kernels' formulas give the bounds ``PERF.md`` lists for the serving
  and training shapes, and ``chip_smoke.py``'s bounds are those formulas.
* ``count()`` counts one smoke prefill (no mesh, and the plan exchange on a
  stacked mesh) and one smoke training step the same on meta tensors as on
  the CPU's plain path, exactly; a kernel wrapper made not to report (a
  planted fault) breaks that equality.
"""

import contextlib
import importlib.util
import os

import pytest
import torch

from repro.launch import roofline as ref_roofline
from repro_torch.configs import smoke_config
from repro_torch.launch import roofline as R
from repro_torch.launch.mesh import make_mesh
from repro_torch.launch.serve import flash_plan, make_prefill_step
from repro_torch.launch.train import (TrainOptions, init_train_state,
                                      make_train_step)
from repro_torch.models import build_model

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
REF_HW = R.HW(peak_flops=ref_roofline.PEAK_FLOPS,
              hbm_bw=ref_roofline.HBM_BW, link_bw=ref_roofline.LINK_BW,
              dcn_bw=ref_roofline.DCN_BW)

# (flops, bytes, simple, wire, ici, dcn, count): tests/test_roofline.py's
# case first, then each term dominant in turn, and an empty program
TERMS = {
    "reference_case": (1.97e14, 819e9, 1e9, 1e9, 5e8, 5e8, 3),
    "compute": (5e15, 1e9, 1e6, 1e6, 1e6, 0.0, 1),
    "memory": (1e12, 5e12, 1e6, 1e6, 0.0, 1e6, 2),
    "collective": (1e9, 1e9, 4e11, 4e11, 1e11, 3e11, 7),
    "empty": (0.0, 0.0, 0.0, 0.0, 0.0, 0.0, 0),
}


@pytest.mark.parametrize("case", list(TERMS))
def test_roofline_terms_equal_the_reference(case):
    flops, nbytes, simple, wire, ici, dcn, n = TERMS[case]
    want = ref_roofline.roofline_terms(
        flops, nbytes, ref_roofline.CollectiveStats(
            simple_bytes=simple, wire_bytes=wire, ici_bytes=ici,
            dcn_bytes=dcn, count=n))
    got = R.roofline_terms(
        flops, nbytes, R.CollectiveStats(
            simple_bytes=simple, wire_bytes=wire, ici_bytes=ici,
            dcn_bytes=dcn, count=n), REF_HW)
    assert got == want


def test_collective_stats_keep_the_reference_fields():
    ref_fields = [f.name for f in ref_roofline.dataclasses.fields(
        ref_roofline.CollectiveStats)]
    ours = [f.name for f in R.dataclasses.fields(R.CollectiveStats)]
    assert ours[:len(ref_fields)] == ref_fields
    assert [f.name for f in R.dataclasses.fields(R.HW)] == [
        f.name for f in ref_roofline.dataclasses.fields(ref_roofline.HW)]


@pytest.mark.parametrize("op", ["all-reduce", "all-gather", "reduce-scatter",
                                "all-to-all", "collective-permute", "other"])
def test_wire_bytes_are_the_reference(op):
    for n in (1, 2, 3, 16, 512):
        for rb in (0, 24, 1 << 20, 3_000_001):
            assert R._wire_bytes(op, rb, n) == \
                ref_roofline._wire_bytes(op, rb, n)


def test_h100_constants():
    hw = R.HW()
    assert (hw.peak_flops, hw.hbm_bw, hw.link_bw, hw.dcn_bw) == (
        989e12, 3.35e12, 450e9, 50e9)
    assert R.PEAK_FLOPS_BY_DTYPE == {"bfloat16": 989e12, "float32": 67e12}


def _chip_smoke():
    spec = importlib.util.spec_from_file_location(
        "chip_smoke_for_tests", os.path.join(REPO, "chip_smoke.py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def _ms(cost):
    flops, nbytes = cost
    ops, moved = flops / R.PEAK_FLOPS * 1e3, nbytes / R.HBM_BW * 1e3
    return max(ops, moved), "ops" if ops >= moved else "bytes"


# PERF.md's bound column (ms, what bounds it), bf16: (shape, formula args)
GMM = {
    "megatron prefill gate/up": ((32, 768, 2048, 8192), 0.8338, "ops"),
    "mixtral prefill gate/up": ((8, 20480, 4096, 14336), 19.455, "ops"),
    "train dX gate/up": ((32, 2304, 8192, 2048), 2.5014, "ops"),
    "train dW gate/up": ((32, 2048, 2304, 8192), 2.5014, "ops"),
}
ATTN = {
    "mixtral prefill": (R.attn_cost, (32, 32, 8, 1024, 128, True, 4096),
                        0.2782, "ops"),
    "train backward": (R.attn_bwd_cost, (32, 32, 8, 512, 64, True, None),
                       0.1008, "bytes"),
    "mixtral long backward": (R.attn_bwd_cost,
                              (1, 32, 8, 8192, 128, True, 4096), 1.0423,
                              "ops"),
}
COPY = {"mixtral prefill": (64 * 2560 * 4096 * 2, 0.8013),
        "megatron prefill": (64 * 384 * 2048 * 2, 0.0601),
        "mixtral decode": (64 * 32 * 4096 * 2, 0.0100)}


def _digits(x):
    return float(f"{x:.5g}") if x >= 1 else round(x, 4)


@pytest.mark.parametrize("name", list(GMM))
def test_gmm_formula_gives_the_listed_bound(name):
    (e, c, d, f), want, by = GMM[name]
    ms, got_by = _ms(R.gmm_cost(e, c, d, f, 2))
    assert (_digits(ms), got_by) == (want, by)
    x = torch.empty(e, c, d, dtype=torch.bfloat16, device="meta")
    w = torch.empty(e, d, f, dtype=torch.bfloat16, device="meta")
    bound, bound_by = _chip_smoke().gmm_bound(x, w)
    assert bound == ms and bound_by == {"ops": "operations"}.get(by, by)


@pytest.mark.parametrize("name", list(ATTN))
def test_attention_formulas_give_the_listed_bounds(name):
    fn, args, want, by = ATTN[name]
    ms, got_by = _ms(fn(*args, 2))
    assert (_digits(ms), got_by) == (want, by)
    smoke = _chip_smoke()
    chip = smoke.attn_bound if fn is R.attn_cost else smoke.attn_bwd_bound
    bound, bound_by = chip(*args, "bfloat16", 2)
    assert bound == ms and bound_by == {"ops": "operations"}.get(by, by)
    assert smoke.band_pairs(*args[3:4], *args[5:7]) == \
        R.band_pairs(args[3], *args[5:7])


@pytest.mark.parametrize("name", list(COPY))
def test_copy_formula_gives_the_listed_bound(name):
    moved, want = COPY[name]
    ms, by = _ms(R.copy_cost(moved))
    assert (round(ms, 4), by) == (want, "bytes")


def test_chip_smoke_rates_are_the_roofline_constants():
    smoke = _chip_smoke()
    assert smoke.hbm_bytes_per_s() == R.HBM_BW
    assert smoke.peak_ops_per_s() == R.PEAK_FLOPS_BY_DTYPE


# -- count(): meta against the CPU's plain path --------------------------------

AXES = ("pod", "data", "model")


def _prefill_counts(arch, device, mesh_shape=None):
    cfg = smoke_config(arch)
    mesh = make_mesh(mesh_shape, AXES, device) if mesh_shape else None
    plan = flash_plan(*mesh_shape[:2]) if mesh_shape else None
    params = build_model(cfg, device).init(torch.Generator().manual_seed(0))
    step = make_prefill_step(cfg, mesh, "plan" if plan else None, plan,
                             device=device)
    tokens = torch.zeros((8, 16), dtype=torch.int64, device=device)
    with R.count() as c:
        step(params, {"tokens": tokens})
    return c.summary()


def _train_counts(arch, device):
    cfg = smoke_config(arch)
    params = build_model(cfg, device, train=True).init(
        torch.Generator().manual_seed(0))
    state = init_train_state(params)
    batch = {k: torch.zeros((4, 16), dtype=torch.int32, device=device)
             for k in ("tokens", "labels")}
    step = make_train_step(cfg, None, TrainOptions(), device=device)
    with R.count() as c:
        step(state, batch)
    return c.summary()


CELLS = {
    "qwen3 prefill": (_prefill_counts, ("qwen3-0.6b",),
                      {"flash_attention"}),
    "megatron prefill": (_prefill_counts, ("megatron-moe-32e",),
                         {"flash_attention", "grouped_matmul"}),
    "megatron plan prefill on (2, 2, 1)": (
        _prefill_counts, ("megatron-moe-32e", (2, 2, 1)),
        {"flash_attention", "grouped_matmul", "a2a_pack", "a2a_unpack"}),
    "megatron train step": (_train_counts, ("megatron-moe-32e",),
                            {"flash_attention", "flash_attention_bwd",
                             "grouped_matmul", "sq_norm", "adamw_step"}),
}


@pytest.mark.parametrize("cell", list(CELLS))
def test_count_is_the_same_on_meta_and_on_the_cpu(cell):
    fn, args, kernels = CELLS[cell]
    cpu, meta = fn(*args[:1], "cpu", *args[1:]), \
        fn(*args[:1], "meta", *args[1:])
    assert set(meta["kernels"]) == kernels
    assert meta["flops"] > sum(k["flops"] for k in meta["kernels"].values())
    assert cpu == meta


@contextlib.contextmanager
def _unreported(name):
    """The planted fault: the wrapper of kernel ``name`` neither reports
    its formula nor hides its own work from the counter."""
    import sys

    module = sys.modules[{
        "a2a_pack": "repro_torch.kernels.a2a_pack.a2a_pack",
        "a2a_unpack": "repro_torch.kernels.a2a_pack.a2a_pack",
        "grouped_matmul": "repro_torch.kernels.grouped_matmul.grouped_matmul",
        "flash_attention":
            "repro_torch.kernels.flash_attention.flash_attention",
        "flash_attention_bwd":
            "repro_torch.kernels.flash_attention.flash_attention",
        "sq_norm": "repro_torch.kernels.adamw.adamw",
        "adamw_step": "repro_torch.kernels.adamw.adamw"}[name]]
    real = module._counted

    def counted(kernel, cost):
        return contextlib.nullcontext() if kernel == name \
            else real(kernel, cost)

    module._counted = counted
    try:
        yield
    finally:
        module._counted = real


FAULTS = {"a2a_pack": "megatron plan prefill on (2, 2, 1)",
          "a2a_unpack": "megatron plan prefill on (2, 2, 1)",
          "grouped_matmul": "megatron prefill",
          "flash_attention": "qwen3 prefill",
          "flash_attention_bwd": "megatron train step",
          "sq_norm": "megatron train step",
          "adamw_step": "megatron train step"}


@pytest.mark.parametrize("kernel", list(FAULTS))
def test_a_wrapper_that_does_not_report_breaks_the_equality(kernel):
    fn, args, _ = CELLS[FAULTS[kernel]]
    with _unreported(kernel):
        cpu, meta = fn(*args[:1], "cpu", *args[1:]), \
            fn(*args[:1], "meta", *args[1:])
    assert kernel not in cpu["kernels"] and kernel not in meta["kernels"]
    assert cpu != meta
