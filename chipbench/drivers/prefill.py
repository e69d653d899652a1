"""A closed loop of prefill batches: each batch of prompts is issued when
the last one's logits are on the host, through the port's
``launch/serve.make_prefill_step`` on the deployment's stacked mesh.

End-to-end: ``prefill_tokens_per_s`` (every prompt token of the batches
the window issued, over the time from its start to the last batch's
logits) and ``ttft_p90_ms`` (the 90th percentile over every batch of the
time from issue to logits on the host, each request's time to first
token), with ``setup_s``.

``correct``: once the window has closed and the program is freed, a sample
of the finished requests drawn from the seed, the same number from each
rank's rows, is run again through the plain reference (f32) on every
branch of its last token's routing ties (``reference/ties.py``); each
request's logit error against its nearest branch is taken by each rank's
median request, and the widest rank is held to the cell's limit
(``compare.served_numbers`` says why not the widest request).
"""

from __future__ import annotations

import time

import numpy as np
import torch

from chipbench import harness, port, weights, yardstick
from chipbench import traffic as traffic_mod
from chipbench.reference import compare, model, ties

# the ties a calibration run walks, wider than any cell's, so that the
# numbers at narrower ties can be read from its branches
CALIBRATION_MARGIN = 0.4


def sample_groups(seed: int, n_batches: int, groups: int, per_group: int):
    """``(batch, group)`` pairs drawn from the seed: for each group (one
    rank's rows, whose tokens share the experts' capacity) ``per_group``
    different batches, or every batch where the window holds fewer."""
    rng = np.random.default_rng(seed)
    k = min(per_group, n_batches)
    return sorted((int(b), g) for g in range(groups)
                  for b in rng.choice(n_batches, size=k, replace=False))


def sampled_prompts(m: dict, tr: dict, seed: int, picks, group_rows: int,
                    device) -> torch.Tensor:
    rows = []
    for b, g in picks:
        tok = traffic_mod.batch(tr, m["vocab"], seed, b, device)["tokens"]
        rows.append(tok[g * group_rows:(g + 1) * group_rows])
    return torch.cat(rows)


def reference_branches(m: dict, tokens: torch.Tensor, seed: int,
                       group_rows: int, margin: float, most: int
                       ) -> ties.Branches:
    """The reference's last-position logits of the sampled requests on
    every branch of their ties."""
    model.exact()
    leaf = weights.LayerLeaves(m, False, seed, tokens.device)
    with torch.no_grad():
        return ties.branches(m, leaf, tokens, group_rows, margin, most=most)


def control_logits(m: dict, tokens: torch.Tensor, seed: int,
                   group_rows: int) -> torch.Tensor:
    """The control: the reference in float8 products, in the program's
    place."""
    model.exact()
    leaf = weights.LayerLeaves(m, False, seed, tokens.device)
    with torch.no_grad():
        return model.last_logits(m, leaf, tokens, group_rows,
                                 model.fp8_matmul)


def run(r: harness.Run) -> dict:
    m = yardstick.config_widths(r.config)
    tr, dev = r.traffic, r.device
    marks = port.Marks(r.t0)
    cfg = port.build(r.config)
    from repro_torch.launch.serve import make_prefill_step

    mesh = port.mesh(r.config, dev)
    plan = port.plan(r.config)
    marks("program imported, plan made")
    params = port.parameters(cfg, r.config, False, r.seed, dev, marks)
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
    br = reference_branches(
        m, tokens, r.seed, group_rows,
        max(margin, CALIBRATION_MARGIN) if r.control else margin,
        256 if r.control else 64)
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
        control = control_logits(m, tokens, r.seed, group_rows)
        out["readings"] = {
            "requests": picks, "program": readings,
            "control": compare.served_numbers(control, br, margin, ranks),
            "program_branches": compare.branch_table(program, br),
            "control_branches": compare.branch_table(control, br)}
    return out
