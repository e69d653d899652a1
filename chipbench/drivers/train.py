"""A closed loop of training steps through the port's
``launch/train.make_train_step`` on the deployment's stacked mesh: one
train state is built, driven through its first three steps (the warm-up,
on batches 0 to 2 of the seed), and handed to the window, whose steps take
batches 3, 4, ...  The window dispatches steps up to ``AHEAD_S`` seconds
ahead of the one it waits for, as a training loop that reads its losses
late does, so that a stall of the host shorter than the work queued
leaves the card fed (how far the host gets ahead is the step's to say: a
step that waits for the card inside itself keeps it within about a
step); the losses are read once the window has closed.  When its time is
up it sends nothing more, waits for every step sent, and reads the clock
after that wait.

End-to-end: ``train_tokens_per_s`` (every token of the window's steps over
the time from its start to the end of that wait, on the host's clock),
``train_step_p90_ms`` (the 90th percentile over every step of the window
of the time from the end of the step before to its end, on the device's
clock: CUDA events recorded after each step, so a stall that starves the
card counts in the step it delays), with ``setup_s`` (the warm-up steps
included; the bookkeeping for the check below left out).

``correct``: the loss of each of the first three steps, the first
gradient as AdamW took it (read from its first moment after step 1) and
the parameters' change after step 3, leaf by leaf, against the reference's
three f32 steps from the same weights and batches, run once the window has
closed and the program is freed.  The control (``calibrate.py``) is the
reference a precision down from the configuration's: products in float8,
parameters and moments in bfloat16.
"""

from __future__ import annotations

import collections
import math
import sys
import time

import torch

from chipbench import harness, port, weights, yardstick
from chipbench import traffic as traffic_mod
from chipbench.reference import compare, model
from chipbench.reference.train import reference_steps

CHECKED_STEPS = 3
# seconds of steps dispatched ahead of the one the window waits for
AHEAD_S = 5.0


class StepClock:
    """Each step's end: a CUDA event on the card (read once the window has
    closed), the host's clock elsewhere (where every step runs to its end
    before the call returns)."""

    def __init__(self, device):
        self.cuda = torch.device(device).type == "cuda"
        self.marks = [self._mark()]

    def _mark(self):
        if not self.cuda:
            return time.perf_counter()
        e = torch.cuda.Event(enable_timing=True)
        e.record()
        return e

    def step_done(self):
        self.marks.append(self._mark())
        return self.marks[-1]

    def wait(self, mark) -> None:
        if self.cuda:
            mark.synchronize()

    def step_seconds(self) -> list:
        pairs = zip(self.marks, self.marks[1:])
        if self.cuda:
            return [a.elapsed_time(b) * 1e-3 for a, b in pairs]
        return [b - a for a, b in pairs]


def readings_of(program: dict, ref: dict) -> dict:
    """The numbers compared: the worst step's loss gap, the worst leaf's
    first-gradient gap, the worst moved leaf's change gap."""
    moved = compare.moved_leaves(ref["first_grad"])
    return {
        "loss_gap": max(compare.rel_gap(a, b)
                        for a, b in zip(program["loss"], ref["loss"])),
        "grad_gap": compare.leaf_gap(program["first_grad"],
                                     ref["first_grad"],
                                     sorted(ref["first_grad"])),
        "change_gap": compare.leaf_gap(program["change"], ref["change"],
                                       moved),
    }


def change_norms(params, leaves, seed: int, device) -> dict:
    """Each leaf's distance from its seeded start, made again leaf by
    leaf."""
    named = dict(params.named_parameters())
    return {leaf.name: float(torch.linalg.vector_norm(
        named[leaf.name] - weights.make(leaf, seed, device)))
        for leaf in leaves}


def options(tr: dict):
    from repro_torch.launch.train import TrainOptions
    from repro_torch.optim import AdamWConfig

    o = tr["options"]
    return TrainOptions(
        peak_lr=o["peak_lr"], warmup_steps=o["warmup_steps"],
        total_steps=o["total_steps"],
        adamw=AdamWConfig(b1=o["b1"], b2=o["b2"], eps=o["eps"],
                          weight_decay=o["weight_decay"],
                          clip_norm=o["clip_norm"]))


def run(r: harness.Run) -> dict:
    m = yardstick.config_widths(r.config)
    tr, dev = r.traffic, r.device
    marks = port.Marks(r.t0)
    cfg = port.build(r.config)
    from repro_torch.launch.train import init_train_state, make_train_step

    mesh = port.mesh(r.config, dev)
    marks("program imported")
    params = port.parameters(cfg, r.config, True, r.seed, dev, marks)
    state = init_train_state(params)
    port.sync(dev)
    marks("moments made")
    step = make_train_step(cfg, mesh, options(tr), device=dev)
    b1 = tr["options"]["b1"]
    leaves = weights.leaves(m, train=True)

    checked = {"loss": []}
    bookkeeping = 0.0
    for i in range(CHECKED_STEPS):
        t = time.perf_counter()
        state, metrics = step(state, traffic_mod.batch(
            tr, m["vocab"], r.seed, i, dev))
        checked["loss"].append(float(metrics["loss"]))
        step_s = time.perf_counter() - t
        t = time.perf_counter()
        with torch.no_grad():
            if i == 0:
                checked["first_grad"] = {
                    k: float(torch.linalg.vector_norm(v)) / (1 - b1)
                    for k, v in state["opt"].m.items()}
            if i == CHECKED_STEPS - 1:
                checked["change"] = change_norms(state["params"], leaves,
                                                 r.seed, dev)
        port.sync(dev)
        bookkeeping += time.perf_counter() - t
        marks(f"checked step {i + 1}")

    rows, s = int(tr["rows"]), int(tr["seq_len"])
    # the last checked step ran alone: its time sets how many steps
    # AHEAD_S holds
    ahead = max(1, math.ceil(AHEAD_S / max(step_s, 1e-3)))
    tracer = harness.Tracer() if r.trace else None
    losses, pending = [], collections.deque()
    t_start = time.perf_counter()
    setup_s = t_start - r.t0 - bookkeeping
    if tracer:
        tracer.start()
    clock = StepClock(dev)
    while time.perf_counter() - t_start < r.seconds:
        b = traffic_mod.batch(tr, m["vocab"], r.seed,
                              CHECKED_STEPS + len(losses), dev)
        state, metrics = step(state, b)
        losses.append(metrics["loss"].detach())
        pending.append(clock.step_done())
        if len(pending) > ahead:
            clock.wait(pending.popleft())
        if tracer and tracer.running \
                and time.perf_counter() - t_start >= harness.TRACE_SECONDS:
            tracer.stop(lambda: port.sync(dev), steps=len(losses),
                        rows=rows, seq_len=s)
    port.sync(dev)
    t_done = time.perf_counter()
    if tracer and tracer.running:
        tracer.stop(lambda: port.sync(dev), steps=len(losses), rows=rows,
                    seq_len=s)
    window_s = t_done - t_start
    times = clock.step_seconds()
    loss = torch.stack(losses).float().cpu()
    failed = int((~torch.isfinite(loss)).sum())
    print(f"window: {len(times)} steps, {ahead} ahead, {window_s:.3f} s; "
          f"step ms " + " ".join(f"{t * 1e3:.1f}" for t in times),
          file=sys.stderr, flush=True)
    peak = port.memory_peak(dev)
    kind = port.device_kind(dev)
    del state, params, step, mesh, metrics, b, losses
    port.release(dev)
    port.report_left(dev)

    model.exact()
    group_rows = rows // port.ranks(r.config)
    ref = reference_steps(m, tr, r.seed, CHECKED_STEPS, group_rows, dev)
    port.report_peak(dev)
    readings = readings_of(checked, ref)
    judged = compare.judge(readings, r.workload["check"]["limits"])
    out = {
        "e2e": {"train_tokens_per_s": len(times) * rows * s / window_s,
                "train_step_p90_ms": yardstick.percentile(times, 90) * 1e3,
                "setup_s": setup_s},
        "attempted": len(times), "failed": failed,
        "correct": judged["ok"] and failed == 0,
        "checks": judged["checks"],
        "memory_peak_bytes": peak, "device_kind": kind,
    }
    if tracer:
        out["record"] = tracer.record()
        out["record"]["model"] = m
    if r.control:
        control = reference_steps(m, tr, r.seed, CHECKED_STEPS, group_rows,
                                  dev, model.fp8_matmul,
                                  state_dtype=torch.bfloat16)
        out["readings"] = {"program": readings,
                           "control": readings_of(control, ref),
                           "program_raw": checked, "reference_raw": ref}
    return out
