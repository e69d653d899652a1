"""Serving-step construction + a batched-request demo server.

Counterpart of ``src/repro/launch/serve.py``.  ``make_prefill_step`` builds
the prompt pass and ``make_serve_step`` the one-token decode step, on a
``LocalMesh`` (all ranks of the JAX mesh stacked on one device) or with no
mesh.  Run directly for a batched-serving demo on the card:

    PYTHONPATH=src python -m repro_torch.launch.serve \\
        --arch megatron-moe-32e --n-layers 4 --mesh 2,16 --a2a plan
    PYTHONPATH=src python -m repro_torch.launch.serve \\
        --arch mixtral-8x7b --n-layers 4 --mesh 2,16 --a2a plan \\
        --batch 32 --prompt-len 1024 --gen-len 16
    PYTHONPATH=src python -m repro_torch.launch.serve \\
        --arch xlstm-125m --smoke --device cpu --plan-server

``--mesh POD,DATA`` is the one-card counterpart of the JAX ``mesh``
argument; ``--device cpu`` runs on the CPU.
"""

from __future__ import annotations

import argparse
import dataclasses
import time
from typing import Optional

import numpy as np
import torch

from ..configs import ModelConfig, get_config, smoke_config
from ..models import build_model
from .mesh import LocalMesh, make_mesh, resolve_device
from .train import make_dist_context

__all__ = ["make_dist_context", "make_serve_step", "make_prefill_step",
           "flash_plan"]


def _device(mesh: Optional[LocalMesh], device) -> torch.device:
    if device is not None:
        return resolve_device(device)
    return mesh.device if mesh is not None else resolve_device("cuda")


def make_serve_step(cfg: ModelConfig, mesh: Optional[LocalMesh],
                    a2a_impl: Optional[str] = None, plan=None, *,
                    use_kernel: bool = True, device=None):
    """(params, cache, tokens [B], pos) -> (logits [B, V], cache).

    ``a2a_impl`` selects the MoE dispatch schedule (a registry name or
    ``"auto"``), ``plan`` is the synthesized Plan/ExecutableSchedule behind
    ``"plan"``.  ``use_kernel=False`` runs the plain versions of the kernels,
    with or without a mesh.  The cache is updated in place.  ``device``
    defaults to the mesh's, else the card.
    """
    model = build_model(cfg, _device(mesh, device))
    dist = make_dist_context(cfg, mesh, a2a_impl, plan, use_kernel) \
        if mesh is not None else None

    @torch.no_grad()
    def serve_step(params, cache, tokens, pos):
        return model.decode_step(params, cache, tokens, pos, dist,
                                 use_kernel=use_kernel)

    return serve_step


def make_prefill_step(cfg: ModelConfig, mesh: Optional[LocalMesh],
                      a2a_impl: Optional[str] = None, plan=None, *,
                      cache_len: Optional[int] = None,
                      use_kernel: bool = True, device=None):
    """(params, batch) -> (last-position logits [B, V], cache).

    ``cache_len`` sizes the decode cache (prompt plus generation budget;
    default: the prompt length, as the reference's ``prefill``); the other
    arguments are ``make_serve_step``'s."""
    model = build_model(cfg, _device(mesh, device))
    dist = make_dist_context(cfg, mesh, a2a_impl, plan, use_kernel) \
        if mesh is not None else None

    @torch.no_grad()
    def prefill_step(params, batch):
        return model.prefill(params, batch, dist, cache_len=cache_len,
                             use_kernel=use_kernel)

    return prefill_step


def flash_plan(n_pods: int, gpus_per_pod: int, seed: int = 0):
    """The FAST (flash) plan for MoE dispatch on ``ClusterSpec(n_pods,
    gpus_per_pod)``, from the port's own scheduler, built as the reference's
    serving demo builds its dispatch workload."""
    from ..core.schedulers import get_scheduler
    from ..core.traffic import ClusterSpec, moe_workload

    w = moe_workload(ClusterSpec(n_pods, gpus_per_pod), tokens_per_gpu=2048,
                     bytes_per_token=2, seed=seed)
    return get_scheduler("flash").synthesize(w)


# -- batched-serving demo -----------------------------------------------------

def _plan_dispatch_schedules(gen_len: int, use_plan_server: bool) -> dict:
    """Plan the MoE dispatch schedule each decode step would issue.

    Models the testbed fabric (4 servers x 8 GPUs) and one drifting MoE
    dispatch matrix per generated token.  With ``use_plan_server`` the plan
    requests route through the plan-serving daemon (``serving/``) and each
    plan comes back with its lowered stage tables (the device handoff);
    the default stays on the inline path, ``simulate_many`` over a
    process-local PlanCache.  Prints the reference's lines and returns
    their counts."""
    from ..core.plan import PlanCache
    from ..core.simulator import simulate_many
    from ..core.traffic import ClusterSpec, moe_workload

    cluster = ClusterSpec(n_servers=4, m_gpus=8)
    # Each decode step re-draws gating for the same token budget; every
    # 4th step repeats a seed (hot signatures), the rest drift.
    traj = [moe_workload(cluster, tokens_per_gpu=2048, bytes_per_token=2,
                         seed=(step // 4 if step % 4 == 0 else step))
            for step in range(gen_len)]
    t0 = time.perf_counter()
    out = {}
    if use_plan_server:
        from ..serving import PlanClient, PlanServer

        with PlanServer(workers=2) as srv:
            client = PlanClient(srv, algorithm="flash")
            results = client.simulate_many(traj)
            # Device handoff: each distinct signature's plan comes back
            # with its lowered stage tables; repeats reuse the memoized
            # lowering (counters["lowered"] counts only the cache misses).
            scheds = [client.get_device_schedule(w)[1] for w in traj]
            srv.drain(10.0)
            stats = srv.telemetry_snapshot()
        counters = stats["counters"]
        route = (f"plan-server: hits={counters.get('hits', 0)} "
                 f"warm={counters.get('warm', 0)} "
                 f"cold={counters.get('cold', 0)} "
                 f"upgrades={counters.get('upgrades', 0)}")
        n_stages = sorted({s.n_stages for s in scheds})
        lowered = client.counters["lowered"]
        print(f"device handoff: {len(scheds)} schedules, {lowered} lowered "
              f"({len(scheds) - lowered} memoized); stage counts "
              f"{n_stages}")
        out.update(schedules=len(scheds), lowered=lowered,
                   memoized=len(scheds) - lowered, stage_counts=n_stages,
                   counters={k: counters.get(k, 0) for k in (
                       "hits", "warm", "cold", "upgrades")})
    else:
        cache = PlanCache(capacity=256, warm_start=True)
        results = simulate_many(traj, "flash", cache=cache)
        route = (f"inline: hits={cache.hits} misses={cache.misses} "
                 f"warm={cache.warm_hits}")
    dt = time.perf_counter() - t0
    mean_us = float(np.mean([r.completion_time for r in results])) * 1e6
    print(f"dispatch planning [{route}] {len(traj)} steps in {dt:.3f}s; "
          f"mean schedule completion {mean_us:.1f}us")
    out.update(route=route, seconds=dt, mean_completion_us=mean_us)
    return out


def _sync(device: torch.device) -> None:
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def main(argv=None):
    from ..comm.all_to_all import available_all_to_all_impls
    from ..comm.plan_exec import lower_plan

    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="qwen3-0.6b")
    ap.add_argument("--smoke", action="store_true")
    ap.add_argument("--batch", type=int, default=4)
    ap.add_argument("--prompt-len", type=int, default=16)
    ap.add_argument("--gen-len", type=int, default=16)
    ap.add_argument("--a2a", default=None,
                    choices=available_all_to_all_impls() + ["auto"],
                    help="MoE All-to-All schedule (registry name, or "
                         "'auto'); defaults to the arch config's a2a_impl")
    ap.add_argument("--plan-server", action="store_true",
                    help="route dispatch-schedule planning through the "
                         "plan-serving daemon (repro_torch.serving) instead "
                         "of the inline PlanCache path")
    ap.add_argument("--mesh", default=None, metavar="POD,DATA",
                    help="serve on a local (POD, DATA, 1) mesh stacked on "
                         "the device; default: no mesh")
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--n-layers", type=int, default=None,
                    help="override the config's depth")
    ap.add_argument("--seed", type=int, default=0)
    args = ap.parse_args(argv)

    cfg = smoke_config(args.arch) if args.smoke else get_config(args.arch)
    if cfg.encdec:
        # the demo feeds token prompts alone; an encoder-decoder needs
        # frames and has no prefill cache (models/model.py)
        ap.error(f"{args.arch} is an encoder-decoder: this demo serves "
                 f"decoder-only archs")
    over = {}
    if args.a2a:
        over["a2a_impl"] = args.a2a
    if args.n_layers:
        over["n_layers"] = args.n_layers
    cfg = dataclasses.replace(cfg, **over) if over else cfg
    device = resolve_device(args.device)
    mesh = plan = None
    if args.mesh:
        pod, data = (int(v) for v in args.mesh.split(","))
        mesh = make_mesh((pod, data, 1), ("pod", "data", "model"), device)
        if cfg.a2a_impl in ("plan", "auto"):
            plan = flash_plan(pod, data, args.seed)
            sched = lower_plan(plan, n_pods=pod)
            print(f"plan: {sched.algorithm} n_plan_stages="
                  f"{sched.n_plan_stages} n_fallback_stages="
                  f"{sched.n_fallback_stages}")
    model = build_model(cfg, device)
    params = model.init(torch.Generator(device=device).manual_seed(args.seed))
    rng = np.random.default_rng(args.seed)
    prompts = torch.from_numpy(rng.integers(
        0, cfg.vocab, (args.batch, args.prompt_len)).astype(np.int64)) \
        .to(device)
    total = args.prompt_len + args.gen_len

    prefill = make_prefill_step(cfg, mesh, cfg.a2a_impl, plan,
                                cache_len=total, device=device)
    step = make_serve_step(cfg, mesh, cfg.a2a_impl, plan, device=device)
    _sync(device)
    t0 = time.perf_counter()
    logits, cache = prefill(params, {"tokens": prompts})
    toks = logits.argmax(-1)
    out = [toks]
    for t in range(args.prompt_len, total - 1):
        logits, cache = step(params, cache, toks, t)
        toks = logits.argmax(-1)
        out.append(toks)
    _sync(device)
    dt = time.perf_counter() - t0
    gen = torch.stack(out, dim=1).cpu().numpy()
    tput = args.batch * gen.shape[1] / dt
    print(f"arch={cfg.name} layers={cfg.n_layers} batch={args.batch} "
          f"generated={gen.shape[1]} tokens/req; {tput:.1f} tok/s total on "
          f"{device}")
    print("sample:", gen[0][:16])
    _plan_dispatch_schedules(args.gen_len, args.plan_server)


if __name__ == "__main__":
    main()
