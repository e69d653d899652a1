"""The dbrx cell at test size on the CPU: d 64, 12 heads over 2 kv heads of
16 (DBRX's GQA group of 6), 8 experts top-4, the cell's own files with
its widths cut (``configs``, ``traffic``; ``"test_size": true``).

* The port against ``reference/dbrx.py`` on the benchmark's seeded leaves
  (``norm_leaves``), the program in f32: on ``LocalMesh((2, 8, 1))``,
  whose 8 experts lie over "data" alone (the intra-pod all-to-all), and on
  the single-device path.  With planted ``wq``, ``wk``, ``wv`` whose
  projections pass ±8 the two agree only with the port's clamp.
* The cell's check in bf16: a sound run is correct, the control and every
  fault (``faults.py``'s and ``faults_more.py``'s) are not.
* The intra-pod readers and ``mfu.prefill`` on a synthetic record, against
  counts worked by hand.
"""

import json
import time

import pytest
import torch

from chipbench import faults_more, harness, norm_leaves, port, weights
from chipbench import traffic as traffic_mod
from chipbench import yardstick
from chipbench.reference import compare, dbrx

CELL = "dbrx-132b.prefill-intra"
SEED = 2 ** 31 + 31
SMALL = dict(n_layers=2, d_model=64, n_heads=12, n_kv_heads=2, head_dim=16,
             d_ff=96, vocab=256, num_experts=8)
ROWS, SEQ = 16, 8


def write_small(root, compute_dtype=None):
    for kind in ("configs", "traffic"):
        (root / kind).mkdir(exist_ok=True)
    cfg = json.loads((harness.HERE / "configs" / "dbrx-132b.json")
                     .read_text())
    cfg["model"].update(SMALL)
    # dropless at test size too: E / k
    cfg["model"]["capacity_factor"] = 2.0
    if compute_dtype:
        cfg["model"]["compute_dtype"] = compute_dtype
    cfg["deployment"]["mesh"] = [2, 8, 1]
    cfg["test_size"] = True
    (root / "configs" / "dbrx-132b.json").write_text(json.dumps(cfg))
    tr = json.loads((harness.HERE / "traffic" / "prefill-dbrx-32x256.json")
                    .read_text())
    tr.update(rows=ROWS, seq_len=SEQ)
    (root / "traffic" / "prefill-dbrx-32x256.json").write_text(
        json.dumps(tr))
    return harness.Suite([root, harness.HERE])


@pytest.fixture
def suite(tmp_path):
    return write_small(tmp_path)


@pytest.fixture
def config(tmp_path):
    write_small(tmp_path, "float32")
    return json.loads((tmp_path / "configs" / "dbrx-132b.json").read_text())


def _planted_leaf(leaf, scale):
    """``leaf`` with the attention's q, k, v projections ``scale`` x."""
    def get(name):
        t = leaf(name)
        return t * scale if name.split(".")[-1] in ("wq", "wk", "wv") else t
    return get


def _port_and_reference(config, mesh_shape, scale=1.0):
    """The port's last-position logits of a seeded batch (through
    ``make_prefill_step``) and the reference's, the program in f32."""
    from repro_torch.launch.serve import make_prefill_step

    m = yardstick.config_widths(config)
    cfg = port.build(config)
    lm = _program(cfg, m)
    if scale != 1.0:
        with torch.no_grad():
            for name, t in lm.named_parameters():
                if name.split(".")[-1] in ("wq", "wk", "wv"):
                    t.mul_(scale)
    mesh = None if mesh_shape is None else port.mesh(
        dict(config, deployment=dict(config["deployment"],
                                     mesh=list(mesh_shape))), "cpu")
    tokens = traffic_mod.batch({"rows": ROWS, "seq_len": SEQ}, m["vocab"],
                               SEED, 0, "cpu")["tokens"]
    logits, _ = make_prefill_step(cfg, mesh, "direct", device="cpu")(
        lm, {"tokens": tokens})
    group = ROWS if mesh is None else ROWS // 16
    leaf = _planted_leaf(weights.LayerLeaves(m, False, SEED, "cpu"), scale)
    dbrx.exact()
    with torch.no_grad():
        ref = dbrx.last_logits(m, leaf, tokens, group)
    return logits, ref


def _program(cfg, m):
    """The port's serving parameters on the CPU, filled as the cell fills
    them."""
    from repro_torch.models import build_model

    lm = build_model(cfg, "cpu").init(torch.Generator())
    norm_leaves.fill_named(dict(lm.named_parameters()), m, False, SEED)
    return lm


@pytest.mark.parametrize("mesh_shape", [(2, 8, 1), None],
                         ids=["intra-pod", "one-device"])
def test_port_agrees_with_the_reference_in_f32(config, mesh_shape):
    logits, ref = _port_and_reference(config, mesh_shape)
    assert float(compare.row_errs(logits, ref).max()) < 1e-5


def test_ep_over_data_alone(config):
    from repro_torch.launch.serve import make_dist_context

    cfg = port.build(config)
    dist = make_dist_context(cfg, port.mesh(config, "cpu"), "direct")
    assert dist.ep_axes == ("data",) and dist.slow_axis == "pod"


@pytest.mark.parametrize("clip", [True, False], ids=["clamp", "no-clamp"])
def test_planted_projections_past_the_clip(config, clip, monkeypatch):
    """Projections of about 30 x their seeded size: the reference clamps
    them, and the port agrees only with its own clamp."""
    from repro_torch.models import published

    if not clip:
        monkeypatch.setattr(published, "CLIP_QKV", {})
    logits, ref = _port_and_reference(config, (2, 8, 1), scale=30.0)
    err = float(compare.row_errs(logits, ref).max())
    if clip:
        assert err < 1e-5
    else:
        assert err > 1e-2


def test_leaves_hold_zero_biases(config):
    m = yardstick.config_widths(config)
    names = {leaf.name for leaf in norm_leaves.leaves(m, False)}
    base = {leaf.name for leaf in weights.leaves(m, False)}
    biases = names - base
    assert biases == {"final_norm.bias"} | {
        f"blocks.{i}.norm{j}.bias" for i in range(m["n_layers"])
        for j in (1, 2)}
    params = dict(_program(port.build(config), m).named_parameters())
    assert all(torch.count_nonzero(params[b]) == 0 for b in biases)
    embed, = (leaf for leaf in weights.leaves(m, False)
              if leaf.name == "embed")
    assert torch.equal(params["embed"], weights.make(embed, SEED, "cpu"))


def test_the_port_must_state_the_clip(suite, monkeypatch):
    from repro_torch.models import published

    monkeypatch.setattr(published, "CLIP_QKV", {})
    with pytest.raises(ValueError, match="clip_qkv"):
        harness.run_cell(suite, CELL, SEED, 0.1, False, "cpu",
                         time.perf_counter())


def _run(suite, control=False):
    return harness.run_cell(suite, CELL, SEED, 0.3, False, "cpu",
                            time.perf_counter(), control=control)


def test_sound_run_is_correct_and_the_control_is_not(suite):
    res = _run(suite, control=True)
    assert res["correct"], res["checks"]
    assert res["attempted"] > 0 and res["failed"] == 0
    limits = {k: v["limit"] for k, v in res["checks"].items()}
    assert not compare.judge(res["readings"]["control"], limits)["ok"]


@pytest.mark.parametrize("fault", ["no_exchange", "pair_skipped",
                                   "half_batch", "token_altered",
                                   "top_k_halved", "norm_uncentred"])
def test_fault_is_not_correct(suite, fault):
    with faults_more.planted(fault):
        res = _run(suite)
    assert not res["correct"], (fault, res["checks"])


def test_unknown_fault_is_refused():
    with pytest.raises(ValueError, match="unknown fault"):
        with faults_more.planted("no_such_fault"):
            pass


# -- the readers ----------------------------------------------------------------

def widths():
    """The cell's own model widths."""
    return yardstick.config_widths(json.loads(
        (harness.HERE / "configs" / "dbrx-132b.json").read_text()))


def record():
    """Two batches of the cell's traffic in a 1 s window: a gmm launch of
    300 ms, two gathers of 4 ms and 6 ms launched inside ``a2a.intra``,
    one of 2 ms launched outside it, and 10 ms of nothing between."""
    return {
        "window_s": 1.0,
        "device_ops": [
            ["gmm_tma_kernel", 0.000, 0.300, 0.0],
            ["index_elementwise_kernel", 0.300, 0.304, 0.2001],
            ["index_elementwise_kernel", 0.314, 0.320, 0.2101],
            ["index_elementwise_kernel", 0.320, 0.322, 0.26],
        ],
        "ranges": {"a2a.intra": [[0.2, 0.201], [0.21, 0.211]],
                   "moe.exchange": [[0.19, 0.27]]},
        "host_ops": [],
        "work": {"batches": 2, "rows": 32, "seq_len": 256},
        "model": widths(),
    }


def test_intra_bytes_by_hand():
    from chipbench import intra_a2a

    # 8192 tokens x 4 rows of 6144 bf16, read and written
    assert intra_a2a.exchange_bytes(widths(), 8192) == 2 * 8192 * 4 * 6144 * 2
    # two batches, 4 layers, two exchanges a layer
    assert intra_a2a.window_bytes(record()) == 2 * 4 * 2 * 805306368
    assert intra_a2a.span_device_s(record()) == pytest.approx(0.010)


def test_intra_share_reader():
    reader = harness.Suite().module("metrics", "intra_a2a_share.dbrx-prefill")
    assert reader.read(record()) == pytest.approx(100 * 0.010 / 0.312)
    # a program without the span (the parent's)
    assert reader.read(dict(record(), ranges={})) is None


def test_intra_roofline_reader():
    reader = harness.Suite().module("metrics",
                                    "intra_a2a_roofline.dbrx-prefill")
    nbytes = 2 * 4 * 2 * 805306368
    assert reader.read(record()) == pytest.approx(
        100 * nbytes / 3.35e12 / 0.010)
    assert reader.read(dict(record(), ranges={})) is None
    assert reader.read(dict(record(), work={})) is None


def test_mfu_reader_on_dbrx():
    """2 x active parameters a token: attention 88,080,384, the router
    98,304, four experts of 198,180,864; causal pairs 32,896 a row; the
    head 2 x 6144 x 100352 a row."""
    reader = harness.Suite().module("metrics", "mfu.prefill")
    active = 88_080_384 + 98_304 + 4 * 198_180_864
    assert yardstick.layer_active_params(widths()) == active
    flops = (2 * 8192 * 4 * active + 4 * 128 * 48 * 4 * 32 * 32_896
             + 2 * 32 * 6144 * 100352)
    assert yardstick.prefill_flops(widths(), 32, 256) == flops
    assert reader.read(record()) == pytest.approx(
        100 * 2 * flops / (0.322 * 989e12))
