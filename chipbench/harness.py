"""Discovery by name, the traced window, and the result line.

Everything that belongs to one configuration, traffic mix, cell or
per-layer metric is a file of its own, found by its name in
``BENCHMARK.json``: ``configs/<config>.json``, ``traffic/<traffic>.json``,
``workloads/<cell>.json``, ``drivers/<kind>.py`` and
``metrics/<metric>.py``.  A ``Suite`` looks in its directories in order,
so a later file of the same name in an earlier directory stands in (the
tests add cells that way).
"""

from __future__ import annotations

import dataclasses
import gzip
import importlib.util
import json
import os
import subprocess
import sys
import tempfile
import time
from pathlib import Path
from types import ModuleType
from typing import Dict, List, Optional, Sequence

from . import yardstick

HERE = Path(__file__).resolve().parent
ROOT = HERE.parent
FORBIDDEN = ("jax", "jaxlib", "flax", "repro")
# the traced part of a --trace 1 run's window, from its start
TRACE_SECONDS = 5.0


class Suite:
    """The benchmark's files, found by name in ``dirs`` (in order)."""

    def __init__(self, dirs: Sequence[Path] = (HERE,),
                 bench: Optional[dict] = None):
        self.dirs = [Path(d) for d in dirs]
        self.bench = bench if bench is not None else json.loads(
            (ROOT / "BENCHMARK.json").read_text())

    def path(self, kind: str, name: str, suffix: str) -> Path:
        for d in self.dirs:
            p = d / kind / f"{name}{suffix}"
            if p.is_file():
                return p
        raise FileNotFoundError(f"no {kind}/{name}{suffix} in "
                                f"{[str(d) for d in self.dirs]}")

    def data(self, kind: str, name: str) -> dict:
        return json.loads(self.path(kind, name, ".json").read_text())

    def module(self, kind: str, name: str) -> ModuleType:
        path = self.path(kind, name, ".py")
        key = f"chipbench._found.{kind}.{name}"
        spec = importlib.util.spec_from_file_location(key, path)
        mod = importlib.util.module_from_spec(spec)
        spec.loader.exec_module(mod)
        return mod

    def cell(self, name: str) -> dict:
        for w in self.bench["workloads"]:
            if w["name"] == name:
                return w
        raise KeyError(f"no cell {name!r} in BENCHMARK.json")

    def metrics(self, cell: str, section: str) -> List[dict]:
        """The ``end_to_end`` or ``per_layer`` metrics a cell reports: those
        that list it, or list no cells (a per-layer metric without a list:
        every cell that reports the end-to-end metric it moves)."""
        if section == "end_to_end":
            return [m for m in self.bench["end_to_end"]
                    if cell in m.get("workloads", [cell])]
        e2e = {m["name"] for m in self.metrics(cell, "end_to_end")}
        return [m for m in self.bench["per_layer"]
                if cell in m.get("workloads", [cell] if m["moves"] in e2e
                                 else [])]


@dataclasses.dataclass
class Run:
    """One run of one cell: what a driver is given."""
    config: dict
    traffic: dict
    workload: dict
    seed: int
    seconds: float
    trace: bool
    device: str
    t0: float                     # the process's start (host clock)
    control: bool = False         # also read the control (calibrate.py)


def forbidden_modules() -> List[str]:
    """Modules loaded in this process whose top-level name is JAX's, Flax's
    or the JAX package's (compared whole: ``repro_torch`` is not
    ``repro``)."""
    return sorted({name for name in sys.modules
                   if name.split(".")[0] in FORBIDDEN})


def power_limit() -> str:
    """``nvidia-smi``'s name and power limit of the card, or why not."""
    try:
        out = subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit",
             "--format=csv,noheader"], capture_output=True, text=True,
            timeout=30)
    except (OSError, subprocess.TimeoutExpired) as e:
        return f"not read ({e.__class__.__name__})"
    return out.stdout.strip().splitlines()[0] if out.stdout.strip() \
        else "not read"


# -- the traced window ---------------------------------------------------------

class Tracer:
    """The profiler over the start of a window, read into a plain record:
    device operations (kernels, copies, sets) with their launch times, the
    program's profiler ranges, and the host's operations.  The profiler's
    own results go straight to a chrome trace in a temporary directory
    under ``TMPDIR`` (deleted once read): building its Python events
    instead takes minutes for a few seconds of a training step."""

    def __init__(self):
        import torch
        from torch.autograd import profiler

        self._torch = torch
        self._prof = profiler.profile(
            use_device="cuda" if torch.cuda.is_available() else None,
            use_kineto=True)
        self.running = False
        self.window_s = None
        self.work: Dict[str, int] = {}

    def start(self) -> None:
        self._prof._prepare_trace()
        self._prof._start_trace()
        self._t = time.perf_counter()
        self.running = True

    def stop(self, sync, **work) -> None:
        """End the traced window after ``sync()``; ``work`` counts what the
        window held (batches, steps)."""
        sync()
        self.window_s = time.perf_counter() - self._t
        self._results = self._torch.autograd._disable_profiler()
        self.running = False
        self.work = work

    def record(self) -> dict:
        t = time.perf_counter()
        with tempfile.TemporaryDirectory() as tmp:
            path = os.path.join(tmp, "trace.json")
            self._results.save(path)
            with open(path, "rb") as f:
                raw = f.read()
        if raw[:2] == b"\x1f\x8b":
            raw = gzip.decompress(raw)
        rec = read_chrome_trace(json.loads(raw), self.window_s, self.work)
        print(f"trace: {len(raw)} bytes, {len(rec['device_ops'])} device "
              f"operations, read in {time.perf_counter() - t:.1f} s",
              file=sys.stderr, flush=True)
        return rec


DEVICE_CATS = {"kernel", "gpu_memcpy", "gpu_memset"}
LAUNCH_CATS = {"cuda_runtime", "cuda_driver"}


def read_chrome_trace(trace: dict, window_s: float, work: dict) -> dict:
    """The record the per-layer metrics read, from a chrome trace: times in
    seconds from the first event."""
    events = [e for e in trace.get("traceEvents", [])
              if e.get("ph") == "X" and "ts" in e]
    t0 = min((float(e["ts"]) for e in events), default=0.0)

    def span(e):
        a = (float(e["ts"]) - t0) * 1e-6
        return a, a + float(e.get("dur", 0.0)) * 1e-6

    launches = {}
    for e in events:
        if e.get("cat") in LAUNCH_CATS:
            corr = (e.get("args") or {}).get("correlation")
            if corr is not None:
                launches[corr] = span(e)[0]
    device, ranges, host = [], {}, []
    for e in events:
        cat = e.get("cat")
        if cat in DEVICE_CATS:
            corr = (e.get("args") or {}).get("correlation")
            a, b = span(e)
            device.append([e.get("name", ""), a, b, launches.get(corr)])
        elif cat == "user_annotation":
            ranges.setdefault(e.get("name", ""), []).append(list(span(e)))
        elif cat == "cpu_op":
            host.append([e.get("name", "")] + list(span(e)))
    device.sort(key=lambda x: x[1])
    return {"window_s": window_s, "device_ops": device, "ranges": ranges,
            "host_ops": host, "work": dict(work)}


def busy_s(record: dict) -> float:
    return yardstick.union_s((a, b) for _, a, b, _ in record["device_ops"])


def device_time(record: dict, *fragments: str) -> float:
    """Summed device time of the operations whose name holds any of
    ``fragments``."""
    return sum(b - a for name, a, b, _ in record["device_ops"]
               if any(f in name for f in fragments))


def breakdown(record: dict, top: int = 10) -> dict:
    """The device operations that took most time, and the longest idle
    gaps, each named by what the host was doing: the host operation that
    overlaps it most, the shorter among equals."""
    by_name: Dict[str, float] = {}
    for name, a, b, _ in record["device_ops"]:
        by_name[name] = by_name.get(name, 0.0) + (b - a)
    ops = sorted(by_name.items(), key=lambda kv: -kv[1])[:top]
    spans = [(a, b) for _, a, b, _ in record["device_ops"]]
    gaps = sorted(yardstick.idle_gaps(spans), key=lambda g: g[0] - g[1])
    idle = []
    for ga, gb in gaps[:top]:
        best, key = "(no host operation)", (0.0, 0.0)
        for name, a, b in record["host_ops"]:
            over = min(b, gb) - max(a, ga)
            if over > 0 and (over, a - b) > key:
                best, key = name, (over, a - b)
        idle.append([best, gb - ga])
    return {"device_ops": [[n, t] for n, t in ops], "idle_gaps": idle}


# -- a run ----------------------------------------------------------------------

def check_cell(suite: Suite, name: str) -> dict:
    """The cell's entry, its files agreeing with it."""
    cell = suite.cell(name)
    workload = suite.data("workloads", name)
    for key in ("config", "traffic", "chips"):
        if workload.get(key) != cell[key]:
            raise ValueError(f"{name}: workloads/{name}.json has {key} "
                             f"{workload.get(key)!r}, BENCHMARK.json "
                             f"{cell[key]!r}")
    return workload


def run_cell(suite: Suite, name: str, seed: int, seconds: float,
             trace: bool, device: str, t0: float,
             control: bool = False) -> dict:
    """Run cell ``name`` and return its result line (a dict); raises where
    the run cannot finish."""
    from .traffic import check as check_traffic

    workload = check_cell(suite, name)
    cell = suite.cell(name)
    config = suite.data("configs", cell["config"])
    traffic = check_traffic(suite.data("traffic", cell["traffic"]))
    run = Run(config, traffic, workload, int(seed), float(seconds),
              bool(trace), device, t0, control)
    out = suite.module("drivers", traffic["driver"]).run(run)

    if trace:
        record = out["record"]
        metrics = {}
        for m in suite.metrics(name, "per_layer"):
            value = suite.module("metrics", m["name"]).read(record)
            if value is not None:
                metrics[m["name"]] = {"value": value, "unit": m["unit"]}
    else:
        metrics = {m["name"]: {"value": out["e2e"][m["name"]],
                               "unit": m["unit"]}
                   for m in suite.metrics(name, "end_to_end")}
    dev = {"platform": "gpu" if device.startswith("cuda") else device,
           "kind": out["device_kind"], "count": int(cell["chips"]),
           "memory_peak_bytes": int(out["memory_peak_bytes"])}
    if trace:
        dev["busy_s"] = busy_s(out["record"])
        dev["window_s"] = out["record"]["window_s"]
    result = {"correct": bool(out["correct"]),
              "attempted": int(out["attempted"]),
              "failed": int(out["failed"]), "metrics": metrics,
              "device": dev}
    if trace:
        result["breakdown"] = breakdown(out["record"])
    if control:
        result["readings"] = out.get("readings", {})
    result["checks"] = out["checks"]
    return result


def emit(result: dict) -> None:
    """Each number compared beside its limit as the last lines of standard
    error, and the result as the last line of standard output."""
    for name, c in result["checks"].items():
        print(f"check {name} {c['value']!r} limit {c['limit']!r}",
              file=sys.stderr, flush=True)
    print(json.dumps(result), flush=True)
