"""The system under test, as the benchmark calls it: the PyTorch/CUDA
port's configuration, mesh, plan and parameters, built from a
configuration file and the benchmark's seeded weights.  Nothing else of
the program is read but its spans, counters and kernel names."""

from __future__ import annotations

import gc
import sys
import time

import torch

from . import weights, yardstick

# the configuration file's widths and the port's ModelConfig fields
WIDTHS = {"n_layers": "n_layers", "d_model": "d_model", "n_heads": "n_heads",
          "n_kv_heads": "n_kv_heads", "d_ff": "d_ff", "vocab": "vocab",
          "swa_window": "swa_window", "rope_theta": "rope_theta",
          "compute_dtype": "compute_dtype", "param_dtype": "param_dtype"}


def build(config: dict):
    """The port's registered configuration of ``config["arch"]``, its depth,
    exchange and expert capacity set as the file says; raises where any
    other width differs from the file's.  A test size (``"test_size": true``) takes
    every width from the file instead."""
    import dataclasses

    from repro_torch.configs import get_config

    m = yardstick.config_widths(config)
    dep = config["deployment"]
    moe = get_config(config["arch"]).moe
    over = dict(n_layers=m["n_layers"], a2a_impl=dep["exchange"],
                remat=dep["remat"], moe=dataclasses.replace(
                    moe, capacity_factor=m["capacity_factor"]))
    if config.get("test_size"):
        over.update({f: m[k] for k, f in WIDTHS.items()},
                    head_dim=m["head_dim"], moe=dataclasses.replace(
                        over["moe"], num_experts=m["num_experts"],
                        top_k=m["top_k"]))
    cfg = get_config(config["arch"], **over)
    got = {k: getattr(cfg, f) for k, f in WIDTHS.items()}
    got.update(head_dim=cfg.resolved_head_dim,
               num_experts=cfg.moe.num_experts, top_k=cfg.moe.top_k,
               capacity_factor=cfg.moe.capacity_factor)
    wrong = {k: (got[k], m.get(k)) for k in got if got[k] != m.get(k)}
    if wrong:
        raise ValueError(f"{config['arch']}: the port's config differs from "
                         f"the file (port, file): {wrong}")
    return cfg


def mesh(config: dict, device):
    from repro_torch.launch.mesh import make_mesh

    return make_mesh(tuple(config["deployment"]["mesh"]),
                     ("pod", "data", "model"), device)


def ranks(config: dict) -> int:
    """The expert-parallel group's ranks the mesh stacks on the card: its
    DP ranks (every axis but "model")."""
    pod, data, _ = config["deployment"]["mesh"]
    return pod * data


def plan(config: dict):
    """The FAST plan of the deployment's two tiers (``pod`` x ``data``),
    from the port's own scheduler, or None for another exchange."""
    dep = config["deployment"]
    if dep["exchange"] != "plan":
        return None
    from repro_torch.launch.serve import flash_plan

    pod, data, _ = dep["mesh"]
    return flash_plan(pod, data, dep["plan_seed"])


def parameters(cfg, config: dict, train: bool, seed: int, device, marks):
    """The port's parameter module on ``device``, every leaf the
    benchmark's seeded one (made in place, one call a leaf)."""
    from repro_torch.models import build_model

    lm = build_model(cfg, "meta", train=train).init(torch.Generator())
    lm = lm.to_empty(device=device)
    sync(device)
    marks("the program's parameter module allocated")
    weights.fill_named(dict(lm.named_parameters()),
                       yardstick.config_widths(config), train, seed)
    sync(device)
    marks("parameters filled from the seed")
    return lm


class Marks:
    """Set-up's parts on standard error: seconds since the process started
    at each mark."""

    def __init__(self, t0: float):
        self.t0 = t0

    def __call__(self, what: str) -> None:
        print(f"setup: {what} at {time.perf_counter() - self.t0:.3f} s",
              file=sys.stderr, flush=True)


def sync(device) -> None:
    if torch.device(device).type == "cuda":
        torch.cuda.synchronize(device)


def device_kind(device) -> str:
    dev = torch.device(device)
    if dev.type == "cuda":
        return torch.cuda.get_device_name(dev)
    return dev.type


def memory_peak(device) -> int:
    dev = torch.device(device)
    if dev.type == "cuda":
        return int(torch.cuda.max_memory_allocated(dev))
    return 0


def release(device) -> None:
    """Return freed memory to the card once the program's state is gone."""
    gc.collect()
    if torch.device(device).type == "cuda":
        torch.cuda.empty_cache()


def report_left(device) -> None:
    """Say on standard error what the freed program left allocated, and
    count the reference's peak from here (``report_peak``)."""
    if torch.device(device).type == "cuda":
        print(f"after the program: {torch.cuda.memory_allocated(device)} "
              f"bytes allocated", file=sys.stderr, flush=True)
        torch.cuda.reset_peak_memory_stats(device)


def report_peak(device) -> None:
    if torch.device(device).type == "cuda":
        print(f"the reference's peak: "
              f"{torch.cuda.max_memory_allocated(device)} bytes",
              file=sys.stderr, flush=True)
