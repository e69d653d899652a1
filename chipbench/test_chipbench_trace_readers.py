"""The readers of the port's own spans and counters: the span shares on a
synthetic trace against hand-worked values, and the counter readers over
a ``trace.snapshot()`` made on the CPU."""

import sys
import warnings

import pytest

from chipbench import harness


def record(**work):
    """Two gmm launches of 1 ms and 3 ms, a pack of 0.5 ms and a flash
    launch of 0.25 ms, in a 10 ms window. The second gmm launch is inside
    attn, the first inside moe.route, the pack inside moe.exchange and
    train.optimizer, the flash inside moe.combine and train.optimizer;
    moe.dispatch holds none."""
    return {
        "window_s": 0.010,
        "device_ops": [
            ["void gmm_tma_kernel<false, false>(...)", 0.000, 0.001, 0.0],
            ["void gmm_tma_kernel<true, false>(...)", 0.001, 0.004, 0.0015],
            ["void block_copy_kernel<uint4>(...)", 0.006, 0.0065, 0.003],
            ["flash_bf16_kernel(Params)", 0.0065, 0.00675, 0.0031],
        ],
        "ranges": {"train.forward_backward": [[0.001, 0.002]],
                   "attn": [[0.0014, 0.0016]],
                   "moe.route": [[0.0, 0.0001]],
                   "moe.dispatch": [[0.0002, 0.0003]],
                   "moe.exchange": [[0.0029, 0.00301]],
                   "moe.combine": [[0.00305, 0.0032]],
                   "train.optimizer": [[0.003, 0.0035]]},
        "host_ops": [],
        "work": dict(work),
    }


# each over the 4.75 ms of device time in the window
@pytest.mark.parametrize("name, share", [
    ("exchange_share.prefill", 100 * 0.5 / 4.75),
    ("moe_glue_share.prefill", 100 * (1 + 0.25) / 4.75),
    ("attn_share.prefill", 100 * 3 / 4.75),
    ("adamw_share.train", 100 * (0.5 + 0.25) / 4.75),
])
def test_span_share_readers_on_a_synthetic_trace(name, share):
    reader = harness.Suite().module("metrics", name)
    rec = record(batches=1)
    assert reader.read(rec) == pytest.approx(share)
    # a program without the span, or a window without device time
    assert reader.read(dict(rec, ranges={})) is None
    assert reader.read(dict(rec, device_ops=[])) is None


@pytest.mark.parametrize("cell, work", [("prefill", "batches"),
                                        ("train", "steps")])
def test_counter_readers_on_a_cpu_snapshot(cell, work, monkeypatch):
    """The program's counters as the port's ``trace`` keeps them on the
    CPU: 8 planted syncs in two steps, and one rank's dropless mixtral
    dispatch (1024 pairs routed, 1000 kept, 8 x 520 grid rows)."""
    import torch

    from repro_torch import trace

    suite = harness.Suite()
    rec = {"work": {work: 2}}
    trace.reset()
    with torch.profiler.profile(), warnings.catch_warnings():
        warnings.simplefilter("ignore")
        for _ in range(2):
            with trace.span("step", syncs=True):
                for _ in range(4):
                    warnings.warn(trace.SYNC_WARNING)
        trace.count("moe.pairs_routed", 1024)
        trace.count_sum("moe.pairs_kept", torch.arange(1024) < 1000)
        trace.count("moe.grid_rows", 8 * 520)
    try:
        assert suite.module("metrics", f"host_syncs.{cell}").read(rec) \
            == 4.0
        assert suite.module("metrics", f"gmm_fill.{cell}").read(rec) == \
            pytest.approx(100 * 1000 / 4160)
        assert suite.module("metrics", f"host_syncs.{cell}").read(
            {"work": {}}) is None
        # a program without the counters: nothing, and no error
        monkeypatch.setitem(sys.modules, "repro_torch.trace", None)
        monkeypatch.delattr(sys.modules["repro_torch"], "trace")
        for name in (f"host_syncs.{cell}", f"gmm_fill.{cell}"):
            assert suite.module("metrics", name).read(rec) is None
    finally:
        trace.reset()
    assert trace.snapshot() == {}
