"""The port's spans and counters (``repro_torch.trace``) on the CPU.

Under ``torch.profiler.profile()`` the MoE layer's spans land in the chrome
trace as user annotations on each of its paths, and the counters equal what
``_dispatch`` kept and what the grouped FFN ran over; the steps' spans
appear around a prefill and a training step.  With the profiler off a span
or counter call is one gate check.  The host-sync count is checked on a
planted warning (a CPU run has no card to sync).  The recurrences' time
loops each open one ``ssm_scan`` span.
"""

import dataclasses
import json
import warnings

import pytest
import torch

from repro_torch import trace
from repro_torch.configs import smoke_config
from repro_torch.data import DataConfig, SyntheticLM
from repro_torch.launch import serve
from repro_torch.launch import train
from repro_torch.launch.mesh import make_mesh
from repro_torch.models import build_model, moe, ssm

MOE_SPANS = {"moe.route", "moe.dispatch", "moe.exchange", "moe.combine"}
# path: (arch, experts, capacity factor, mesh, exchange)
PATHS = {
    # megatron's experts over (pod, data): the island
    "island-plan": ("megatron-moe-32e", 4, 2.0, (2, 2, 1), "plan"),
    # mixtral's 4 experts over pod alone on 6 ranks: the split island
    "pod-ep-plan": ("mixtral-8x7b", 4, 2.0, (2, 3, 1), "plan"),
    "pod-ep-drops": ("mixtral-8x7b", 4, 0.5, (2, 3, 1), "plan"),
    "local": ("megatron-moe-32e", 4, 2.0, None, None),
    "local-drops": ("megatron-moe-32e", 4, 0.5, None, None),
}


def _layer(name):
    arch, experts, cf, shape, impl = PATHS[name]
    cfg = smoke_config(arch)
    cfg = dataclasses.replace(
        cfg, compute_dtype="float32",
        moe=dataclasses.replace(cfg.moe, num_experts=experts,
                                capacity_factor=cf))
    layer = moe.MoE(cfg, torch.Generator().manual_seed(0), torch.float32,
                    "cpu")
    dist = None
    if shape is not None:
        mesh = make_mesh(shape, ("pod", "data", "model"), device="cpu")
        dist = serve.make_dist_context(
            cfg, mesh, impl, serve.flash_plan(shape[0], shape[1]))
    x = torch.randn((12, 8, cfg.d_model),
                    generator=torch.Generator().manual_seed(1)) * 0.3
    return cfg, layer, dist, x


def _annotations(prof, tmp_path):
    """The names of the chrome trace's user annotations, as the benchmark
    reads them."""
    path = tmp_path / "trace.json"
    prof.export_chrome_trace(str(path))
    return {e["name"] for e in json.loads(path.read_text())["traceEvents"]
            if e.get("cat") == "user_annotation"}


@pytest.fixture(autouse=True)
def fresh_counters():
    trace.reset()
    yield
    trace.reset()


@pytest.mark.parametrize("name", sorted(PATHS))
def test_moe_spans_land_in_the_trace(name, tmp_path):
    cfg, layer, dist, x = _layer(name)
    with torch.profiler.profile() as prof, torch.no_grad():
        moe.moe_apply(cfg, layer, x, dist)
    got = _annotations(prof, tmp_path) & MOE_SPANS
    # the local path has no exchange
    want = MOE_SPANS - {"moe.exchange"} if dist is None else MOE_SPANS
    assert got == want


@pytest.mark.parametrize("name", sorted(PATHS))
def test_counters_equal_the_kept_pairs_and_the_grid(name, monkeypatch):
    cfg, layer, dist, x = _layer(name)
    seen = {"kept": 0, "rows": 0, "routed": 0}
    dispatch, ffn = moe._dispatch, moe._expert_ffn

    def spy_dispatch(x_flat, eids, capacity, n_experts):
        buf, slot, keep = dispatch(x_flat, eids, capacity, n_experts)
        seen["kept"] += int(keep.sum())
        seen["routed"] += keep.numel()
        return buf, slot, keep

    def spy_ffn(cfg, w_gate, w_up, w_down, tokens, counts=None, *a, **k):
        seen["rows"] += int(counts.sum()) if counts is not None \
            else tokens.shape[0] * tokens.shape[1]
        return ffn(cfg, w_gate, w_up, w_down, tokens, counts, *a, **k)

    monkeypatch.setattr(moe, "_dispatch", spy_dispatch)
    monkeypatch.setattr(moe, "_expert_ffn", spy_ffn)
    with torch.profiler.profile(), torch.no_grad():
        moe.moe_apply(cfg, layer, x, dist)
    got = trace.snapshot()
    assert seen["routed"] == x.shape[0] * x.shape[1] * cfg.moe.top_k
    assert got == {"moe.pairs_routed": seen["routed"],
                   "moe.pairs_kept": seen["kept"],
                   "moe.grid_rows": seen["rows"]}
    # a capacity under the load drops pairs
    assert (got["moe.pairs_kept"] < got["moe.pairs_routed"]) \
        == name.endswith("drops")


# block: (arch its widths come from, module, apply)
SCANS = {
    "mlstm": ("xlstm-125m", ssm.MLSTM, ssm.mlstm_apply),
    "slstm": ("xlstm-125m", ssm.SLSTM, ssm.slstm_apply),
    "mamba": ("hymba-1.5b", ssm.Mamba, ssm.mamba_apply),
}


@pytest.mark.parametrize("block", sorted(SCANS))
def test_scan_loops_open_one_span_each(block, tmp_path):
    arch, module, apply = SCANS[block]
    cfg = smoke_config(arch)
    p = module(cfg, torch.Generator().manual_seed(0), torch.float32, "cpu")
    x = torch.randn((2, 5, cfg.d_model),
                    generator=torch.Generator().manual_seed(1)) * 0.3
    with torch.profiler.profile() as prof, torch.no_grad():
        apply(cfg, p, x)
    path = tmp_path / "trace.json"
    prof.export_chrome_trace(str(path))
    names = [e["name"] for e in json.loads(path.read_text())["traceEvents"]
             if e.get("cat") == "user_annotation"]
    assert names.count("ssm_scan") == 1


class _Untouchable:
    """Fails on any use beyond being passed."""

    def __getattr__(self, name):
        raise AssertionError(f"touched .{name} with the profiler off")


def test_profiler_off_is_one_gate_check(monkeypatch):
    calls = []

    def gate():
        calls.append(1)
        return False

    def refuse(*a, **k):
        raise AssertionError("span code ran with the profiler off")

    monkeypatch.setattr(trace, "_on", gate)
    monkeypatch.setattr(torch.profiler, "record_function", refuse)
    monkeypatch.setattr(torch.cuda, "set_sync_debug_mode", refuse)
    monkeypatch.setattr(torch.cuda, "get_sync_debug_mode", refuse)
    monkeypatch.setattr(warnings, "catch_warnings", refuse)
    assert trace.span("attn") is trace._NULL
    assert trace.span("train.step", syncs=True) is trace._NULL
    trace.count("moe.grid_rows", _Untouchable())
    trace.count_sum("moe.pairs_kept", _Untouchable())
    assert len(calls) == 4
    # a whole MoE layer, off: nothing counted
    monkeypatch.undo()
    cfg, layer, dist, x = _layer("local")
    with torch.no_grad():
        moe.moe_apply(cfg, layer, x, dist)
    assert trace.snapshot() == {} and trace.sync_sites() == {}


@pytest.mark.parametrize("raises", [False, True])
def test_host_syncs_counted_and_state_restored(raises, monkeypatch):
    modes = ["default"]

    def set_mode(mode):
        modes.append(mode)

    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
    monkeypatch.setattr(torch.cuda, "get_sync_debug_mode",
                        lambda: modes[-1])
    monkeypatch.setattr(torch.cuda, "set_sync_debug_mode", set_mode)
    filters = list(warnings.filters)
    with torch.profiler.profile(), \
            pytest.warns(UserWarning, match="not a sync") as other:
        try:
            with trace.span("serve.prefill", syncs=True):
                assert modes[-1] == "warn"
                for _ in range(3):
                    warnings.warn(trace.SYNC_WARNING)    # planted
                warnings.warn("not a sync")
                if raises:
                    raise RuntimeError("mid-step")
        except RuntimeError:
            assert raises
    assert modes == ["default", "warn", "default"]
    assert warnings.filters == filters
    assert trace.snapshot() == {"host_syncs": 3}
    (site, n), = trace.sync_sites().items()
    assert site.startswith(__file__) and n == 3
    # the other warning was issued again, once the span had closed
    assert [str(w.message) for w in other] == ["not a sync"]


def test_steps_open_their_spans(tmp_path):
    cfg = smoke_config("megatron-moe-32e")
    mesh = make_mesh((2, 2, 1), ("pod", "data", "model"), device="cpu")
    params = build_model(cfg, "cpu").init(torch.Generator().manual_seed(0))
    prefill = serve.make_prefill_step(cfg, mesh, "plan",
                                      serve.flash_plan(2, 2), device="cpu")
    step = train.make_train_step(cfg, mesh, device="cpu")
    state = train.init_train_state(build_model(cfg, "cpu", train=True).init(
        torch.Generator().manual_seed(0)))
    data = SyntheticLM(DataConfig(vocab=cfg.vocab, seq_len=16,
                                  global_batch=8, seed=0), cfg)
    with torch.profiler.profile() as prof:
        prefill(params, {"tokens": torch.as_tensor(data.batch(0)["tokens"])})
        step(state, data.batch(1))
    assert {"serve.prefill", "train.step", "train.forward_backward",
            "train.optimizer", "attn"} | MOE_SPANS <= \
        _annotations(prof, tmp_path)
    # no card, no syncs counted; the counters cover both steps
    got = trace.snapshot()
    assert "host_syncs" not in got
    assert got["moe.pairs_routed"] > 0 and got["moe.grid_rows"] > 0
