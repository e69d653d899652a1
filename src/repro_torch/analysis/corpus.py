"""Golden plan corpus for the workload-independent verifier.

``emit_corpus`` synthesizes a small, deterministic battery of plans --
every registered scheduler crossed with uniform / random / skewed / MoE
traffic on homogeneous and degraded fabrics -- and serializes each to
JSON.  The CI analysis gate (``python -m repro.analysis --all``) then
runs ``planlint.check_paths`` over the emitted files: any scheduler
change that starts producing structurally invalid plans (incast,
slot overflow, unsorted cold stages, fingerprint drift) fails the gate
even if no unit test exercises that exact configuration.

Seeds and shapes are fixed so the corpus is reproducible; the
``benchmarks/emit_corpus.py`` wrapper exposes this as a benchmark-suite
entry point.
"""

from __future__ import annotations

import json
import os
from typing import Dict, List

from ..core.schedulers import SCHEDULERS, get_scheduler
from ..core.topology import Topology
from ..core.traffic import (
    ClusterSpec,
    Workload,
    balanced_workload,
    moe_workload,
    random_workload,
    skewed_workload,
)

__all__ = ["corpus_workloads", "emit_corpus"]

_MB = 1e6


def corpus_workloads() -> List[Dict]:
    """The named workload battery: ``{"name", "workload"}`` entries."""
    small = ClusterSpec(n_servers=4, m_gpus=2)
    mid = ClusterSpec(n_servers=8, m_gpus=4)
    entries = [
        {"name": "uniform_n4", "workload": balanced_workload(small, _MB)},
        {"name": "random_n8",
         "workload": random_workload(mid, _MB, seed=7)},
        {"name": "skewed_n8",
         "workload": skewed_workload(mid, _MB, zipf_s=1.4, seed=11)},
        {"name": "moe_n8",
         "workload": moe_workload(mid, tokens_per_gpu=512,
                                  bytes_per_token=2048, seed=3)},
    ]
    # A degraded fabric: one NIC at 30 percent -- the capacity-aware
    # schedulers must stay slot-vs-rail feasible here, not just on the
    # homogeneous happy path.
    degraded = Topology.from_cluster(mid).degrade_nic(2, 1, 0.3, "both")
    w = random_workload(mid, _MB, seed=19)
    entries.append({"name": "degraded_n8",
                    "workload": Workload(w.cluster, w.matrix, degraded)})
    return entries


def emit_corpus(out_dir: str, algorithms: List[str] = None) -> List[str]:
    """Synthesize and serialize the corpus; returns written file paths.

    One JSON file per workload, each holding a list of plan dicts (one
    per scheduler) -- the layout ``planlint.check_paths`` consumes.
    """
    os.makedirs(out_dir, exist_ok=True)
    algos = sorted(SCHEDULERS) if algorithms is None else algorithms
    written: List[str] = []
    for entry in corpus_workloads():
        plans = []
        for algo in algos:
            plan = get_scheduler(algo).synthesize(entry["workload"])
            plans.append(plan.to_dict())
        path = os.path.join(out_dir, f"{entry['name']}.json")
        with open(path, "w") as f:
            json.dump(plans, f, indent=1, sort_keys=True)
        written.append(path)
    return written
