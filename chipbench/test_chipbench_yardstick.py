"""The yardstick's counts against hand-worked values at the two cells'
shapes, and the metric arithmetic on synthetic traces."""

import json
import statistics

import pytest

from chipbench import harness, yardstick

CONFIGS = harness.HERE / "configs"


def widths(name):
    return yardstick.config_widths(
        json.loads((CONFIGS / f"{name}.json").read_text()))


def test_mixtral_prefill_counts():
    m = widths("mixtral-8x7b")
    # wq, wo 4096 x 4096 each; wk, wv 4096 x (8 x 128) each
    assert yardstick.attn_params(m) == 2 * 16_777_216 + 2 * 4_194_304
    assert yardstick.expert_params(m) == 3 * 4096 * 14336 == 176_160_768
    # attention + router (4096 x 8) + two experts
    assert yardstick.layer_active_params(m) == \
        41_943_040 + 32_768 + 352_321_536 == 394_297_344
    assert yardstick.visible_pairs(512, 4096) == 512 * 513 // 2 == 131_328
    flops = yardstick.prefill_flops(m, 32, 512)
    assert flops == (2 * 16_384 * 4 * 394_297_344          # products
                     + 4 * 128 * 32 * 4 * 32 * 131_328     # attention
                     + 2 * 32 * 4096 * 32_000)             # last-row head
    assert flops == 51_965_144_858_624
    assert flops / 16_384 == pytest.approx(3.1717e9, rel=1e-4)
    # 32768 routed rows, 2 x 4096 x 14336 a row and product, 3 products
    assert yardstick.gmm_work(m, 16_384, backward=False) == (
        3 * 2 * 32_768 * 4096 * 14_336,
        3 * (32_768 * 4096 + 32_768 * 14_336 + 8 * 4096 * 14_336) * 2)
    assert yardstick.exchange_bytes(m, 16_384) == \
        4 * 32_768 * 4096 * 2 == 1_073_741_824
    assert yardstick.attn_work(m, 32, 512) == (
        4 * 128 * 32 * 32 * 131_328, 32 * 512 * 128 * (2 * 32 + 2 * 8) * 2)


def test_megatron_train_counts():
    m = widths("megatron-moe-32e")
    assert yardstick.attn_params(m) == 2 * 4_194_304 + 2 * 1_048_576
    assert yardstick.layer_active_params(m) == \
        10_485_760 + 65_536 + 2 * 50_331_648 == 111_214_592
    flops = yardstick.train_flops(m, 32, 512)
    assert flops == (6 * 16_384 * (2 * 111_214_592 + 2048 * 50_304)
                     + 12 * 64 * 32 * 2 * 32 * 131_328)
    assert flops == 32_199_772_471_296
    assert flops / 16_384 == pytest.approx(1.9653e9, rel=1e-4)
    assert yardstick.gmm_work(m, 16_384, backward=True) == (
        9 * 2 * 32_768 * 2048 * 8192,
        9 * (32_768 * 2048 + 32_768 * 8192 + 32 * 2048 * 8192) * 2)


def test_windowed_pairs_and_bounds():
    # 8 queries, window 3: 1 + 2 + 3 * 6
    assert yardstick.visible_pairs(8, 3) == 21
    assert yardstick.visible_pairs(8, None) == 36
    assert yardstick.bound_s(989e12, 0) == pytest.approx(1.0)
    assert yardstick.bound_s(0, 3.35e12) == pytest.approx(1.0)
    assert yardstick.bound_s(989e12, 2 * 3.35e12) == pytest.approx(2.0)


def test_time_arithmetic():
    spans = [(0.0, 1.0), (0.5, 2.0), (3.0, 4.0), (3.5, 3.6), (6.0, 7.0)]
    assert yardstick.union_s(spans) == pytest.approx(4.0)
    assert yardstick.idle_gaps(spans) == [(2.0, 3.0), (4.0, 6.0)]
    assert yardstick.idle_share(spans) == pytest.approx(3 / 7)
    assert yardstick.idle_share([]) is None
    assert yardstick.device_span(spans) == pytest.approx(7.0)
    assert yardstick.device_span([]) is None
    xs = [float(i) for i in range(1, 11)]
    assert yardstick.percentile(xs, 90) == pytest.approx(9.1)
    assert yardstick.percentile(xs, 50) == pytest.approx(5.5)
    # the tail is over every sample: one slow step of ten moves p90
    assert yardstick.percentile(xs[:-1] + [100.0], 90) == pytest.approx(
        9 + 0.1 * 91)
    q1, med, q3 = statistics.quantiles(xs, n=4)
    assert yardstick.spread(xs) == pytest.approx((q3 - q1) / med)


def record(m, **work):
    """Two gmm launches of 1 ms and 3 ms, a pack of 0.5 ms and a flash
    launch of 0.25 ms, in a 10 ms window with one 2 ms gap; the second
    gmm launch is inside train.forward_backward."""
    return {
        "window_s": 0.010,
        "device_ops": [
            ["void gmm_tma_kernel<false, false>(...)", 0.000, 0.001, 0.0],
            ["void gmm_tma_kernel<true, false>(...)", 0.001, 0.004, 0.0015],
            ["void block_copy_kernel<uint4>(...)", 0.006, 0.0065, 0.003],
            ["flash_bf16_kernel(Params)", 0.0065, 0.00675, 0.0031],
        ],
        "ranges": {"train.forward_backward": [[0.001, 0.002]]},
        "host_ops": [["aten::mm", 0.0035, 0.0045],
                     ["aten::copy_", 0.004, 0.0058]],
        "work": dict(work), "model": m,
    }


def test_metric_readers_on_a_synthetic_trace():
    suite = harness.Suite()
    m = widths("mixtral-8x7b")
    rec = record(m, batches=1, rows=32, seq_len=512)

    def read(name, r=rec):
        return suite.module("metrics", name).read(r)

    f, b = yardstick.gmm_work(m, 16_384, False)
    assert read("gmm_roofline.prefill") == pytest.approx(
        100 * 4 * yardstick.bound_s(f, b) / 0.004)
    assert read("a2a_roofline.prefill") == pytest.approx(
        100 * 8 * 1_073_741_824 / 3.35e12 / 0.0005)
    f, b = yardstick.attn_work(m, 32, 512)
    assert read("attn_roofline.prefill") == pytest.approx(
        100 * 4 * yardstick.bound_s(f, b) / 0.00025)
    # over the 6.75 ms from the first device operation to the last
    assert read("mfu.prefill") == pytest.approx(
        100 * 51_965_144_858_624 / (0.00675 * 989e12))
    # busy 0.004 + 0.00075 of the 0.00675 from the first op to the last
    assert read("idle_share.prefill") == pytest.approx(100 * 2 / 6.75)
    # 3 ms of the 4.75 ms of device time launched inside the range
    assert read("optimizer_share.train") == pytest.approx(
        100 * 1.75 / 4.75)
    empty = dict(rec, device_ops=[], ranges={})
    for name in ("gmm_roofline.prefill", "a2a_roofline.prefill",
                 "attn_roofline.prefill", "idle_share.prefill",
                 "optimizer_share.train", "mfu.prefill"):
        assert read(name, empty) is None
    assert read("mfu.train") is None     # no steps in a prefill's record
    meg = widths("megatron-moe-32e")
    train = record(meg, steps=2, rows=32, seq_len=512)
    f, b = yardstick.gmm_work(meg, 16_384, True)
    assert suite.module("metrics", "gmm_roofline.train").read(train) == \
        pytest.approx(100 * 2 * 2 * yardstick.bound_s(f, b) / 0.004)
    assert suite.module("metrics", "mfu.train").read(train) == \
        pytest.approx(100 * 2 * 32_199_772_471_296 / (0.00675 * 989e12))


def test_breakdown_names_ops_and_what_the_host_did():
    rec = record(widths("mixtral-8x7b"), batches=1, rows=32, seq_len=512)
    out = harness.breakdown(rec)
    assert out["device_ops"][0][0].startswith("void gmm_tma_kernel<true")
    assert out["device_ops"][0][1] == pytest.approx(0.003)
    # the gap 0.004 .. 0.006: aten::copy_ overlaps it 1.8 ms, aten::mm 0.5
    assert out["idle_gaps"] == [["aten::copy_", pytest.approx(0.002)]]
    rec["device_ops"].append(["late", 0.0100, 0.0101, None])
    assert [g[1] for g in harness.breakdown(rec)["idle_gaps"]] == [
        pytest.approx(0.00325), pytest.approx(0.002)]
    assert len(out["device_ops"]) <= 10


def test_chrome_trace_is_read_into_a_record():
    trace = {"traceEvents": [
        {"ph": "X", "cat": "cuda_runtime", "name": "cudaLaunchKernel",
         "ts": 100.0, "dur": 5.0, "args": {"correlation": 7}},
        {"ph": "X", "cat": "kernel", "name": "gmm_tma_kernel<false, false>",
         "ts": 110.0, "dur": 1000.0, "args": {"correlation": 7}},
        {"ph": "X", "cat": "gpu_memcpy", "name": "Memcpy HtoD",
         "ts": 1200.0, "dur": 10.0, "args": {"correlation": 9}},
        {"ph": "X", "cat": "user_annotation",
         "name": "train.forward_backward", "ts": 90.0, "dur": 50.0},
        {"ph": "X", "cat": "cpu_op", "name": "aten::mm", "ts": 95.0,
         "dur": 20.0},
        {"ph": "i", "cat": "kernel", "name": "instant", "ts": 5.0},
    ]}
    rec = harness.read_chrome_trace(trace, 0.5, {"steps": 1})
    assert rec["device_ops"][0] == ["gmm_tma_kernel<false, false>",
                                    pytest.approx(20e-6),
                                    pytest.approx(1020e-6),
                                    pytest.approx(10e-6)]
    assert rec["device_ops"][1][3] is None
    assert rec["ranges"]["train.forward_backward"] == [
        [0.0, pytest.approx(50e-6)]]
    assert rec["host_ops"] == [["aten::mm", pytest.approx(5e-6),
                                pytest.approx(25e-6)]]
    assert harness.busy_s(rec) == pytest.approx(1010e-6)
    assert rec["window_s"] == 0.5 and rec["work"] == {"steps": 1}
