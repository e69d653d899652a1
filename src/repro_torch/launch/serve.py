"""Serving-step construction + a batched-request demo server.

Counterpart of ``src/repro/launch/serve.py``.  ``make_prefill_step`` builds
the prompt pass and ``make_serve_step`` the one-token decode step, on a
``LocalMesh`` (all ranks of the JAX mesh stacked on one device), on a
``ProcessMesh`` (this process's rank: its batch rows and its shard of the
parameters, ``serve_procs``) or with no mesh.  ``serve_state_shapes`` gives
the parameters' and cache's shapes (meta tensors) and specs.  Run directly
for a batched-serving demo on the card:

    PYTHONPATH=src python -m repro_torch.launch.serve \\
        --arch megatron-moe-32e --n-layers 4 --mesh 2,16 --a2a plan
    PYTHONPATH=src python -m repro_torch.launch.serve \\
        --arch mixtral-8x7b --n-layers 4 --mesh 2,16 --a2a plan \\
        --batch 32 --prompt-len 1024 --gen-len 16
    PYTHONPATH=src python -m repro_torch.launch.serve \\
        --arch xlstm-125m --smoke --device cpu --plan-server

``--mesh POD,DATA`` is the one-card counterpart of the JAX ``mesh``
argument; ``--device cpu`` runs on the CPU.  ``--procs`` serves on one
process per rank instead (``--backend`` gloo or nccl; under gloo the ranks
may share one card and exchange through host memory; ``--init-method``
names the rendezvous), rank 0 printing the gathered tokens:

    PYTHONPATH=src python -m repro_torch.launch.serve \\
        --arch megatron-moe-32e --smoke --device cpu --mesh 2,2 --procs \\
        --backend gloo

On ``--mesh 2,3`` mixtral's experts go over ``pod`` alone (8 divides
neither 6 nor 3), so each of the 6 processes runs the split island on its
``E_loc`` experts:

    PYTHONPATH=src python -m repro_torch.launch.serve \\
        --arch mixtral-8x7b --smoke --device cpu --mesh 2,3 --batch 6 \\
        --procs --backend gloo

A third entry, ``--mesh POD,DATA,MODEL``, adds tensor parallelism over
"model" on the processes (``models/tp.py``): each holds its slice of the
heads, the FFN's and the experts' hidden dim and the vocabulary, and a DP
rank's prompts go to each of its model peers (8 processes here):

    PYTHONPATH=src python -m repro_torch.launch.serve \\
        --arch megatron-moe-32e --smoke --device cpu --mesh 2,2,2 --procs \\
        --backend gloo

"model" may cut through the kv heads and the query heads: where it cuts
through them (the reference's 16-way TP over 8 kv heads, internvl2-1b's
14 query heads at 16) the columns are gathered over "model" after the
projection, each process computes the whole query heads its columns touch
and the kv heads they read, and keeps its own columns of the output.  A
leaf whose dim "model" does not divide stays whole (the reference's
``_drop_uneven``).  The smoke llama3.2-1b (8 heads, 2 kv heads) on 8
processes, and megatron-moe-32e at its published widths (32 heads, 8 kv
heads) on 16 processes sharing one card:

    PYTHONPATH=src python -m repro_torch.launch.serve \\
        --arch llama3.2-1b --smoke --device cpu --mesh 1,1,8 --procs \\
        --backend gloo --batch 4
    PYTHONPATH=src python -m repro_torch.launch.serve \\
        --arch megatron-moe-32e --n-layers 2 --mesh 1,1,16 --procs \\
        --backend gloo --batch 32 --prompt-len 128 --gen-len 16

The recurrent and hybrid families run over "model" as well
(``models/ssm.py``), and ``--pure-dp`` replicates the weights and cuts the
prompts over every axis (the MoE routes each ``(pod, data)`` shard's rows
together, as the reference's):

    PYTHONPATH=src python -m repro_torch.launch.serve \\
        --arch hymba-1.5b --smoke --device cpu --mesh 1,1,4 --procs \\
        --backend gloo
    PYTHONPATH=src python -m repro_torch.launch.serve \\
        --arch megatron-moe-32e --smoke --device cpu --mesh 1,2,2 \\
        --pure-dp --procs --backend gloo

``--seq-shard`` and ``--fsdp`` serve the same tokens with sequence
parallelism (the prompt pass's residual on a sequence chunk) and FSDP
(every weight gathered at each use, decode steps included):

    PYTHONPATH=src python -m repro_torch.launch.serve \\
        --arch megatron-moe-32e --smoke --device cpu --mesh 1,2,2 --procs \\
        --backend gloo --seq-shard --fsdp --prompt-len 7

In code, ``serve_procs`` also serves an encoder-decoder (whisper-tiny,
given its ``frames`` in ``extras``) and the vision stub's
``patch_embeds``; the demo below feeds token prompts alone and refuses
encoder-decoders.
"""

from __future__ import annotations

import argparse
import dataclasses
import gc
import time
from typing import Optional

import numpy as np
import torch

from ..configs import ModelConfig, get_config, smoke_config
from ..models import build_model
from ..models.transformer import greedy_tokens
from .mesh import make_mesh, parse_mesh, resolve_device
from .train import make_dist_context

__all__ = ["make_dist_context", "make_serve_step", "make_prefill_step",
           "flash_plan", "serve_state_shapes", "serve_procs"]

AXES = ("pod", "data", "model")


def serve_state_shapes(cfg: ModelConfig, mesh, batch: int, seq_len: int):
    """(params_shape, param specs, cache_shape, cache specs) in the
    reference's layout, meta tensors (no memory); the specs are None
    without a mesh.  The serving parameters keep the expert stacks in the
    compute dtype (``models/moe.py``); their shapes are the reference's."""
    from .shardings import cache_specs, cache_tree, param_specs, param_tree

    model = build_model(cfg, "meta")
    params = param_tree(model.init(torch.Generator()), cfg)
    cache = cache_tree(model.init_cache(batch, seq_len), cfg)
    if mesh is None:
        return params, None, cache, None
    return (params, param_specs(cfg, mesh, params), cache,
            cache_specs(cfg, mesh, cache))


def _device(mesh, device) -> torch.device:
    if device is not None:
        return resolve_device(device)
    return mesh.device if mesh is not None else resolve_device("cuda")


def make_serve_step(cfg: ModelConfig, mesh,
                    a2a_impl: Optional[str] = None, plan=None, *,
                    use_kernel: bool = True, device=None):
    """(params, cache, tokens [B], pos) -> (logits [B, V], cache).

    ``a2a_impl`` selects the MoE dispatch schedule (a registry name or
    ``"auto"``), ``plan`` is the synthesized Plan/ExecutableSchedule behind
    ``"plan"``.  ``use_kernel=False`` runs the plain versions of the kernels,
    with or without a mesh.  The cache is updated in place.  ``device``
    defaults to the mesh's, else the card.  On a ``ProcessMesh`` the
    parameters, cache and tokens are this process's (``serve_procs``).
    """
    model = build_model(cfg, _device(mesh, device))
    dist = make_dist_context(cfg, mesh, a2a_impl, plan, use_kernel) \
        if mesh is not None else None

    @torch.no_grad()
    def serve_step(params, cache, tokens, pos):
        return model.decode_step(params, cache, tokens, pos, dist,
                                 use_kernel=use_kernel)

    return serve_step


def make_prefill_step(cfg: ModelConfig, mesh,
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


def _encdec_prefill(cfg: ModelConfig, mesh, params, batch: dict,
                    total: int, step):
    """An encoder-decoder's prompt pass, as its serving runs it: the
    encoder and the cross K/V (``encdec_init_cache`` with the frames), then
    the decode step over each prompt token (the teacher-forced chain).
    Returns (the last position's logits, the cache)."""
    from ..models.encdec import encdec_init_cache

    rows = batch["tokens"]
    dist = make_dist_context(cfg, mesh) if mesh is not None else None
    with torch.no_grad():
        cache = encdec_init_cache(cfg, rows.shape[0], total, batch["frames"],
                                  params, dist=dist)
    for t in range(rows.shape[1]):
        logits, cache = step(params, cache, rows[:, t], t)
    return logits, cache


def _greedy(mesh, cfg: ModelConfig, params, rows: torch.Tensor, spec,
            impl: Optional[str], plan, gen_len: int,
            extras: Optional[dict] = None) -> dict:
    """Prefill this rank's ``rows`` (with its rows of ``extras``: the vision
    stub's ``patch_embeds``, an encoder-decoder's ``frames``) and decode
    greedily to ``gen_len`` tokens, gathering each step's logits (over the
    DP axes, and over "model" where the vocabulary is sharded) and the
    tokens (returned on rank 0; ``{}`` on the others).  A token is the
    argmax over every vocabulary shard (``transformer.greedy_tokens``)."""
    from .shardings import gather_tensor

    prompt = rows.shape[1]
    total = prompt + gen_len
    step = make_serve_step(cfg, mesh, impl, plan)
    dist = make_dist_context(cfg, mesh, impl, plan)
    batch = {"tokens": rows, **(extras or {})}
    if cfg.encdec:
        logits, cache = _encdec_prefill(cfg, mesh, params, batch, total,
                                        step)
    else:
        logits, cache = make_prefill_step(cfg, mesh, impl, plan,
                                          cache_len=total)(params, batch)
    vocab = "model" if logits.shape[-1] != cfg.vocab else None
    logits_spec = (spec[0], vocab)
    steps = [gather_tensor(logits, logits_spec, mesh)]
    toks = greedy_tokens(cfg, logits, dist)
    out = [toks]
    for t in range(prompt, total - 1):
        logits, cache = step(params, cache, toks, t)
        steps.append(gather_tensor(logits, logits_spec, mesh))
        toks = greedy_tokens(cfg, logits, dist)
        out.append(toks)
    gen = gather_tensor(torch.stack(out, dim=1), spec, mesh)
    if mesh.rank:
        return {}
    return {"logits": [lg.cpu() for lg in steps], "tokens": gen.cpu()}


def _serve_rank(mesh, cfg: ModelConfig, holder: list, prompts: torch.Tensor,
                extras: dict, impl: Optional[str], plan, gen_len: int,
                handoff=None, hook=None) -> dict:
    """One rank of ``serve_procs``: cut this process's shard of the
    parameters in ``holder`` (emptied) and its rows of the prompts and of
    ``extras``; with ``handoff`` (a barrier shared with the parent) wait
    until every rank holds its shard and again until the parent has
    dropped the whole; then serve (``_greedy``).  ``hook(mesh, cfg, shards, rows, serve)``, when
    given, runs in place of the serve: ``shards`` is a list holding the
    shard (pop it to free it), and ``serve()`` is the serve, which the hook
    must call once; its result goes back under ``"hook"``.  A hook that
    reads this rank's ``extras`` rows finds them in ``serve.extras``."""
    from ..convert import shard_module
    from .procs import RENDEZVOUS_TIMEOUT_S
    from .shardings import batch_specs, shard_tensor

    shards = [shard_module(holder.pop(), cfg, mesh)]
    gc.collect()
    if handoff is not None:
        handoff.wait(timeout=RENDEZVOUS_TIMEOUT_S)  # every rank holds its own
        handoff.wait(timeout=RENDEZVOUS_TIMEOUT_S)  # the parent dropped all
    specs = batch_specs(mesh, {"tokens": prompts, **extras},
                        pure_dp=cfg.pure_dp and not cfg.fsdp)
    spec = specs["tokens"]
    rows = shard_tensor(prompts, spec, mesh).to(mesh.device)
    own = {k: shard_tensor(v, specs[k], mesh).to(mesh.device)
           for k, v in extras.items()}
    if hook is None:
        return _greedy(mesh, cfg, shards[0], rows, spec, impl, plan, gen_len,
                       own)
    served = []

    def serve() -> dict:
        served.append(_greedy(mesh, cfg, shards[0], rows, spec, impl, plan,
                              gen_len, own))
        return served[-1]

    serve.extras = own
    extra = hook(mesh, cfg, shards, rows, serve)
    if len(served) != 1:
        raise RuntimeError(f"serve_procs: the hook served {len(served)} "
                           f"times, not once")
    return {**served[0], "hook": extra}


def serve_procs(cfg: ModelConfig, params, prompts: torch.Tensor,
                mesh_shape, backend: str, device="cuda",
                a2a_impl: Optional[str] = None, plan=None,
                gen_len: int = 16, hook=None,
                extras: Optional[dict] = None, **spawn_kw) -> dict:
    """Serve ``prompts [B, S]`` on one process per rank of ``mesh_shape``
    (pod, data, model): each process takes its shard of ``params`` (a
    module or ``{name: tensor}``, shared with it without a copy: CUDA IPC
    on the card) and its ``B / (pod * data)`` rows (the same rows on each
    of a DP rank's model peers; under ``pure_dp`` its own ``B / (pod *
    data * model)``, ``batch_specs``), prefills and decodes ``gen_len``
    greedy tokens.  A recurrent or hybrid arch's decode state holds this
    process's channels or touched heads (``models/ssm.py``;
    ``shardings.whole_states`` puts the peers' together).  ``extras`` (``{name: [B, ...]}``: the vision stub's
    ``patch_embeds``, an encoder-decoder's ``frames``, which it needs) are
    cut by rows as the prompts; an encoder-decoder's prompt pass is the
    encoder and the cross K/V, then the decode step over the prompt
    (``_encdec_prefill``).

    ``params`` may come in a one-element list, which is emptied: once every
    process holds its shard, the parent drops its own references to the
    whole and frees what the children no longer map, before any process
    serves.  A caller that keeps no other reference so frees the card of
    the whole model (on the card ``card_used_gb`` reports the memory in use
    before and after that drop).

    Returns rank 0's gather: ``logits`` (the prefill's, then each decode
    step's, ``[B, V]``) and ``tokens [B, gen_len]``; under ``torchrun``
    (this process one rank) the other ranks get ``{}``.  With ``hook``
    (``_serve_rank``), ``ranks`` holds each rank's hook result.
    ``spawn_kw`` reaches ``procs.spawn`` (``init_method``, ``timeout``,
    ``join_timeout``)."""
    from .procs import spawn, spawn_with_handoff, under_torchrun
    from .shardings import named_params

    holder = params if isinstance(params, list) else [params]
    # the list the children unpickle; the spawned Process objects keep it
    named = [{k: v.detach() for k, v in named_params(holder.pop()).items()}]
    shape, dev = tuple(mesh_shape), resolve_device(device)
    # the prompts go by value: a child holds its rows to its end, and CUDA
    # IPC wants every child to release a shared tensor before the parent
    # exits
    if cfg.encdec and "frames" not in (extras or {}):
        raise ValueError(f"{cfg.name} is an encoder-decoder: serve_procs "
                         f"needs its frames in extras")
    args = (shape, AXES, backend, device, cfg, named, prompts.cpu(),
            {k: torch.as_tensor(v).cpu() for k, v in (extras or {}).items()},
            a2a_impl, plan, gen_len)
    if under_torchrun():
        out = spawn(_serve_rank, *args, None, hook, **spawn_kw)
        return _rank0(out, hook)
    out, used = spawn_with_handoff(
        lambda handoff: spawn(_serve_rank, *args, handoff, hook, **spawn_kw),
        named, int(np.prod(shape)), dev)
    res = _rank0(out, hook)
    if used:
        res["card_used_gb"] = used
    return res


def _rank0(out: list, hook) -> dict:
    res = {k: v for k, v in out[0].items() if k != "hook"}
    if hook is not None:
        res["ranks"] = [o["hook"] for o in out]
    return res


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
    ap.add_argument("--mesh", default=None, metavar="POD,DATA[,MODEL]",
                    help="serve on a local (POD, DATA, MODEL) mesh stacked "
                         "on the device (MODEL defaults to 1; the stacked "
                         "mesh keeps whole weights; with --procs, TP over "
                         "MODEL); default: no mesh")
    ap.add_argument("--procs", action="store_true",
                    help="serve the --mesh on one process per rank")
    ap.add_argument("--backend", default=None, choices=("gloo", "nccl"),
                    help="the process groups' backend (with --procs): "
                         "gloo moves the exchange through host memory and "
                         "lets ranks share one card; nccl needs a card per "
                         "rank")
    ap.add_argument("--init-method", default=None,
                    help="the process world's rendezvous (with --procs), "
                         "e.g. file:///tmp/store; default: a file store in "
                         "a fresh temporary directory")
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--n-layers", type=int, default=None,
                    help="override the config's depth")
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--pure-dp", action="store_true",
                    help="the config's pure_dp: weights replicated, the "
                         "prompts cut over every mesh axis")
    ap.add_argument("--seq-shard", action="store_true",
                    help="the config's seq_shard_activations: the residual "
                         "stream on a sequence chunk between the TP regions "
                         "(with --procs and a MODEL above 1)")
    ap.add_argument("--fsdp", action="store_true",
                    help="the config's fsdp: each weight stored over the "
                         "intra-pod DP axes, gathered before use (with "
                         "--procs)")
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
    if args.pure_dp:
        over["pure_dp"] = True
    if args.seq_shard:
        over["seq_shard_activations"] = True
    if args.fsdp:
        over["fsdp"] = True
    cfg = dataclasses.replace(cfg, **over) if over else cfg
    device = resolve_device(args.device)
    if args.procs and not (args.mesh and args.backend):
        ap.error("--procs needs --mesh and --backend")
    mesh = plan = None
    if args.mesh:
        try:
            shape = parse_mesh(args.mesh)
        except ValueError as e:
            ap.error(str(e))
        pod, data, _ = shape
        if not args.procs:
            mesh = make_mesh(shape, AXES, device)
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

    if args.procs:
        holder = [params]
        del params  # serve_procs drops the whole once every rank has its own
        _sync(device)
        t0 = time.perf_counter()
        res = serve_procs(cfg, holder, prompts, shape, args.backend,
                          args.device, cfg.a2a_impl, plan, args.gen_len,
                          init_method=args.init_method)
        dt = time.perf_counter() - t0
        if not res:  # a rank other than 0 under torchrun
            return
        gen = res["tokens"].numpy()
        print(f"arch={cfg.name} layers={cfg.n_layers} batch={args.batch} "
              f"generated={gen.shape[1]} tokens/req on {int(np.prod(shape))} "
              f"processes ({args.backend}, {device}); {dt:.3f} s with the "
              f"processes' start-up")
        print("sample:", gen[0][:16])
        if "card_used_gb" in res:
            print("card memory in use (GB): " + ", ".join(
                f"{k} {v:.2f}" for k, v in res["card_used_gb"].items()))
        _plan_dispatch_schedules(args.gen_len, args.plan_server)
        return

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
