"""The reader of ``adamw_roofline.train``: its parameter count against
the port's own model, and its share on a synthetic trace."""

import pytest

from chipbench import harness


def _megatron_widths():
    import json

    from chipbench import yardstick

    config = json.loads(
        (harness.HERE / "configs" / "megatron-moe-32e.json").read_text())
    return config, yardstick.config_widths(config)


def test_adamw_roofline_counts_the_ports_parameters():
    """The reader's parameters of megatron-moe-32e are the port's own, all
    f32: 23 leaves, 3,448,383,488 parameters, 28 B each a step."""
    import torch

    from chipbench import port
    from repro_torch.models import build_model

    config, m = _megatron_widths()
    reader = harness.Suite().module("metrics", "adamw_roofline.train")
    n, nbytes = reader.parameters(m)
    model = build_model(port.build(config), "meta", train=True).init(
        torch.Generator())
    params = list(model.parameters())
    assert len(params) == 23
    assert n == sum(p.numel() for p in params) == 3_448_383_488
    assert {p.dtype for p in params} == {torch.float32}
    assert nbytes == 28 * n


def test_adamw_roofline_on_a_synthetic_trace():
    """Two steps whose updates take 40 ms of device time each (one kernel
    launched inside each ``adamw.update`` span, one outside), against the
    update's 28 B a parameter at 3.35 TB/s."""
    from chipbench import yardstick

    _, m = _megatron_widths()
    reader = harness.Suite().module("metrics", "adamw_roofline.train")
    rec = {"window_s": 1.0, "model": m, "work": {"steps": 2},
           "ranges": {"adamw.update": [[0.1, 0.2], [0.6, 0.7]],
                      "train.optimizer": [[0.05, 0.25]]},
           "device_ops": [["adamw_kernel<float, float>", 0.15, 0.19, 0.11],
                          ["adamw_kernel<float, float>", 0.65, 0.69, 0.61],
                          ["sq_norm_kernel<float>", 0.12, 0.13, 0.06]],
           "host_ops": []}
    want = 100 * 2 * 28 * 3_448_383_488 / yardstick.PEAK_HBM_BYTES_PER_S \
        / 0.08
    assert reader.read(rec) == pytest.approx(want)
    assert 0 < want < 100
    # a program without the span, or a window without steps
    assert reader.read(dict(rec, ranges={})) is None
    assert reader.read(dict(rec, work={})) is None
