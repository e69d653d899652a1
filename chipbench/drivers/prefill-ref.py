"""``drivers/prefill.py``'s closed loop of prefill batches, for a
configuration that names its own plain reference: ``"reference":
"<module>"`` of ``chipbench/reference/``, which gives ``exact``,
``last_logits``, ``branches`` (``ties.branches``' form) and
``fp8_matmul``.  A later configuration of this kind brings its reference
module and runs through this file.

Before a weight is made the port is held to what the file states beyond
the widths that ``port.build`` compares: its norm (``model.norm``, whose
LayerNorm leaves are ``norm_leaves``') and its clamp of q, k and v
(``model.clip_qkv``, against the ``clip_qkv`` each attention block of the
program's parameter module holds, on meta tensors).  A program that does
not state them does not run the cell.

End-to-end metrics and ``correct`` as ``drivers/prefill.py`` has them:
``prefill_tokens_per_s``, ``ttft_p90_ms`` and ``setup_s``; each rank's
median request's logit error against the nearest branch of the
reference's ties, the widest rank held to the cell's limit.  With
``Run.control`` (``calibrate.py``) also the control's readings: the
reference in float8 products in the program's place.
"""

from __future__ import annotations

import importlib
import time

import torch

from chipbench import harness, norm_leaves, port, weights, yardstick
from chipbench import traffic as traffic_mod
from chipbench.drivers.prefill import (CALIBRATION_MARGIN, sample_groups,
                                       sampled_prompts)
from chipbench.reference import compare


def reference(config: dict):
    """The configuration's plain reference module."""
    return importlib.import_module(f"chipbench.reference."
                                   f"{config['reference']}")


def check_details(config: dict, cfg, lm) -> None:
    """Raise where the port's configuration, or its parameter module
    ``lm``, differs from the file in its norm or its clamp of q, k and v."""
    m = config["model"]
    clips = {getattr(b.attn, "clip_qkv", None) for b in lm.blocks}
    got = {"norm": cfg.norm,
           "clip_qkv": clips.pop() if len(clips) == 1 else sorted(clips)}
    want = {"norm": m.get("norm", "rmsnorm"), "clip_qkv": m.get("clip_qkv")}
    if got != want:
        raise ValueError(f"{config['arch']}: the port's config differs from "
                         f"the file (port, file): "
                         f"{ {k: (got[k], want[k]) for k in got} }")


def parameters(config: dict, cfg, m: dict, seed: int, device, marks):
    """The port's serving parameter module on ``device``, every leaf the
    benchmark's seeded one (``norm_leaves``), once ``check_details``
    passes."""
    from repro_torch.models import build_model

    lm = build_model(cfg, "meta").init(torch.Generator())
    check_details(config, cfg, lm)
    lm = lm.to_empty(device=device)
    port.sync(device)
    marks("the program's parameter module allocated")
    norm_leaves.fill_named(dict(lm.named_parameters()), m, False, seed)
    port.sync(device)
    marks("parameters filled from the seed")
    return lm


def run(r: harness.Run) -> dict:
    m = yardstick.config_widths(r.config)
    tr, dev = r.traffic, r.device
    marks = port.Marks(r.t0)
    cfg = port.build(r.config)
    ref = reference(r.config)
    from repro_torch.launch.serve import make_prefill_step

    mesh = port.mesh(r.config, dev)
    plan = port.plan(r.config)
    marks("program imported, plan made")
    params = parameters(r.config, cfg, m, r.seed, dev, marks)
    step = make_prefill_step(cfg, mesh, cfg.a2a_impl, plan, device=dev)
    rows = int(tr["rows"])
    group_rows = rows // port.ranks(r.config)
    for i in (-1, -2):            # warm every shape the window uses
        step(params, traffic_mod.batch(tr, m["vocab"], r.seed, i, dev))
        port.sync(dev)
        marks(f"warm-up prefill {-i}")

    tracer = harness.Tracer() if r.trace else None
    served, ttft = [], []
    t_start = time.perf_counter()
    setup_s = t_start - r.t0
    if tracer:
        tracer.start()
    t_done = t_start
    while t_done - t_start < r.seconds:
        b = traffic_mod.batch(tr, m["vocab"], r.seed, len(served), dev)
        t_issue = time.perf_counter()
        logits, cache = step(params, b)
        served.append(logits.to("cpu"))
        t_done = time.perf_counter()
        del cache
        ttft.append(t_done - t_issue)
        if tracer and tracer.running \
                and t_done - t_start >= harness.TRACE_SECONDS:
            tracer.stop(lambda: port.sync(dev), batches=len(served),
                        rows=rows, seq_len=int(tr["seq_len"]))
    if tracer and tracer.running:
        tracer.stop(lambda: port.sync(dev), batches=len(served), rows=rows,
                    seq_len=int(tr["seq_len"]))
    window_s = t_done - t_start
    peak = port.memory_peak(dev)
    kind = port.device_kind(dev)
    del step, params, mesh, plan, logits, b
    port.release(dev)
    port.report_left(dev)

    check = r.workload["check"]
    picks = sample_groups(r.seed, len(served), rows // group_rows,
                          check["requests_per_rank"])
    ranks = [g for _, g in picks for _ in range(group_rows)]
    program = torch.cat([served[b][g * group_rows:(g + 1) * group_rows]
                         for b, g in picks]).to(dev)
    tokens = sampled_prompts(m, tr, r.seed, picks, group_rows, dev)
    margin = check["tie_margin"]
    ref.exact()
    leaf = weights.LayerLeaves(m, False, r.seed, dev)
    with torch.no_grad():
        br = ref.branches(
            m, leaf, tokens, group_rows,
            max(margin, CALIBRATION_MARGIN) if r.control else margin,
            most=256 if r.control else 64)
    port.report_peak(dev)
    readings = compare.served_numbers(program, br, margin, ranks)
    judged = compare.judge(readings, check["limits"])
    out = {
        "e2e": {"prefill_tokens_per_s":
                len(served) * rows * int(tr["seq_len"]) / window_s,
                "ttft_p90_ms": yardstick.percentile(ttft, 90) * 1e3,
                "setup_s": setup_s},
        "attempted": len(served) * rows, "failed": 0,
        "correct": judged["ok"], "checks": judged["checks"],
        "memory_peak_bytes": peak, "device_kind": kind,
    }
    if tracer:
        out["record"] = tracer.record()
        out["record"]["model"] = m
    if r.control:
        with torch.no_grad():
            control = ref.last_logits(m, leaf, tokens, group_rows,
                                      ref.fp8_matmul)
        out["readings"] = {
            "requests": picks, "program": readings,
            "control": compare.served_numbers(control, br, margin, ranks),
            "program_branches": compare.branch_table(program, br),
            "control_branches": compare.branch_table(control, br)}
    return out
