"""Train-step construction + a training CLI.

Counterpart of ``src/repro/launch/train.py``.  ``make_train_step`` builds the
``(state, batch) -> (state, metrics)`` step: the loss and its gradient
(through the kernels' backward passes), optional gradient accumulation over
microbatches and int8 error-feedback compression over the pod axis, then
AdamW on the cosine schedule.  The state is ``{"params": LM, "opt":
OptState, "step": int32 scalar}`` (``init_train_state``) and is updated in
place: the reference's functional update would need a second copy of the
full-width state.  On a ``LocalMesh`` every rank's batch shard runs stacked
on one device, so a gradient is one tensor per parameter, the same on every
rank.  On a ``ProcessMesh`` (one OS process per rank) the state is this
process's shard (``convert.shard_module(..., train=True)``), the step takes
the global batch and runs its own rows, and after the backward each
gradient is summed over the DP axes its parameter is replicated on, then
divided by the DP world size: the reference's gradient of the mean loss
(``train_procs`` starts the processes).  Under ``pure_dp`` the batch is
cut over every axis, "model" included, the weights are whole, and the sums
and the metrics' means run over every axis.  The loss and its backward run
inside a ``train.forward_backward`` profiler range, the sync inside
``train.grad_sync``.

Run directly to train on the card (or ``--device cpu``):

    PYTHONPATH=src python -m repro_torch.launch.train \\
        --arch megatron-moe-32e --n-layers 2 --mesh 2,16 --batch 32 \\
        --seq 512 --steps 4
    PYTHONPATH=src python -m repro_torch.launch.train \\
        --arch megatron-moe-32e --smoke --device cpu --mesh 2,2 --batch 8 \\
        --seq 32 --steps 20

``--ckpt-dir`` runs the steps through the fault-tolerant ``Trainer``
(resume, preemption, checkpoints); without it no checkpoint is written (at
full width one holds 55 GB).  ``--procs`` trains the ``--mesh`` on one
process per rank (``--backend`` gloo or nccl; under gloo the ranks may
share one card and exchange through host memory, a rehearsal of the
per-process program rather than a fabric), rank 0 printing the steps:

    PYTHONPATH=src python -m repro_torch.launch.train \\
        --arch megatron-moe-32e --smoke --device cpu --mesh 2,2 --procs \\
        --backend gloo --batch 8 --seq 32 --steps 4
    PYTHONPATH=src python -m repro_torch.launch.train \\
        --arch mixtral-8x7b --smoke --device cpu --mesh 2,3 --procs \\
        --backend gloo --batch 12 --seq 16 --steps 2

``--mesh POD,DATA,MODEL`` adds tensor parallelism over "model" on the
processes (``models/tp.py``; 8 here).  Where "model" cuts through the kv
heads, as on (2, 1, 4) for the smoke config's 4 heads over 2 kv heads, or
through a query head, the columns are gathered over "model" and their
gradients summed back; an encoder-decoder trains the same way, its
batch's ``frames`` cut by DP rows as the tokens (the smoke whisper-tiny's
4 heads on 4 processes, 1 a process):

    PYTHONPATH=src python -m repro_torch.launch.train \\
        --arch megatron-moe-32e --smoke --device cpu --mesh 2,2,2 --procs \\
        --backend gloo --batch 8 --seq 32 --steps 4
    PYTHONPATH=src python -m repro_torch.launch.train \\
        --arch megatron-moe-32e --smoke --device cpu --mesh 2,1,4 --procs \\
        --backend gloo --batch 8 --seq 16 --steps 2
    PYTHONPATH=src python -m repro_torch.launch.train \\
        --arch whisper-tiny --smoke --device cpu --mesh 1,1,4 --procs \\
        --backend gloo --batch 4 --seq 16 --steps 2

The recurrent and hybrid families run over "model" too (``models/ssm.py``:
the smoke xlstm-125m's half a head of mLSTM and 8 sLSTM channels a
process here), and ``--pure-dp`` replicates the weights and cuts the batch
over every axis, the reference's knob for small models:

    PYTHONPATH=src python -m repro_torch.launch.train \\
        --arch xlstm-125m --smoke --device cpu --mesh 1,1,4 --procs \\
        --backend gloo --batch 4 --seq 16 --steps 2
    PYTHONPATH=src python -m repro_torch.launch.train \\
        --arch megatron-moe-32e --smoke --device cpu --mesh 1,2,2 \\
        --pure-dp --procs --backend gloo --batch 8 --seq 16 --steps 2

``--seq-shard`` (the config's ``seq_shard_activations``: the residual
stream on a sequence chunk between the TP regions) and ``--fsdp`` (each
weight stored over the intra-pod DP axes and gathered before use) take
the same steps, apart or together, with ``--pure-dp`` too:

    PYTHONPATH=src python -m repro_torch.launch.train \\
        --arch qwen3-0.6b --smoke --device cpu --mesh 1,2,2 --procs \\
        --backend gloo --fsdp --seq-shard --batch 4 --seq 16 --steps 2
"""

from __future__ import annotations

import argparse
import dataclasses
import gc
import itertools
import time
from typing import Any, Dict, Optional, Tuple

import numpy as np
import torch

from .. import trace
from ..configs import ModelConfig, get_config, smoke_config
from ..models import DistContext, build_model, choose_ep_axes
from ..models.sharding import MeshRules
from ..optim import AdamWConfig, OptState, adamw_update, cosine_schedule, \
    init_opt_state
from .mesh import (ProcessMesh, all_gather, dp_axes, make_mesh,
                   member_sum, parse_mesh, resolve_device, slow_axis)

__all__ = ["TrainOptions", "make_dist_context", "make_train_step",
           "init_train_state", "make_rules", "make_train_state_shapes",
           "train_specs", "train_procs"]


@dataclasses.dataclass(frozen=True)
class TrainOptions:
    peak_lr: float = 3e-4
    warmup_steps: int = 100
    total_steps: int = 10_000
    adamw: AdamWConfig = AdamWConfig()
    # beyond-paper distributed-optimization knobs
    grad_compression: bool = False   # int8 EF gradient sync over the pod axis
    microbatches: int = 1            # grad accumulation: divides live
                                     # activation memory, same math


def make_dist_context(cfg: ModelConfig, mesh,
                      a2a_impl: Optional[str] = None, plan=None,
                      use_kernel: bool = True) -> DistContext:
    """Build the DistContext; ``a2a_impl`` overrides the config's choice.

    The name is validated against the comm-layer registry, so a typo fails
    here and not inside the model.  ``use_kernel=False`` makes the MoE run
    the plain versions of the kernels.
    """
    from ..comm.all_to_all import all_to_all_by_name

    impl = a2a_impl or cfg.a2a_impl
    if impl != "auto":
        all_to_all_by_name(impl)  # raises on unknown impls
    if impl == "plan" and plan is None:
        raise ValueError('a2a_impl="plan" needs a synthesized plan; pass '
                         "plan=")
    fsdp = None
    if cfg.fsdp and isinstance(mesh, ProcessMesh):
        from .shardings import fsdp_layout

        fsdp = fsdp_layout(cfg, mesh)
    return DistContext(
        mesh=mesh,
        dp_axes=dp_axes(mesh),
        slow_axis=slow_axis(mesh),
        ep_axes=choose_ep_axes(cfg, mesh),
        a2a_impl=impl,
        plan=plan,
        use_kernel=use_kernel,
        pure_dp=cfg.pure_dp,
        seq_shard=cfg.seq_shard_activations,
        fsdp=fsdp,
    )


def make_rules(cfg: ModelConfig, mesh) -> MeshRules:
    """The logical-axis rules of ``cfg`` on ``mesh`` (the reference's)."""
    act_seq = "model" if cfg.seq_shard_activations else None
    if cfg.pure_dp:
        # no TP: weights replicated (or FSDP-stored); batch over every axis
        # unless FSDP needs the model axis for parameter storage
        batch = dp_axes(mesh) if cfg.fsdp else tuple(mesh.axis_names)
        return MeshRules(mesh=mesh, batch=batch,
                         act_seq=None, heads=None, kv_heads=None,
                         head_dim=None, ff=None, vocab=None,
                         expert_ff=None, model_dim=None, kv_feature=None)
    return MeshRules(mesh=mesh, batch=dp_axes(mesh), act_seq=act_seq)


def make_train_state_shapes(cfg: ModelConfig, mesh):
    """(state tree of meta tensors in the reference's layout, its specs or
    None without a mesh): ``{"params", "opt": OptState(m, v, count),
    "step"}``, the moments f32 beside each parameter."""
    from .shardings import param_tree, state_specs
    from .shardings import tree_map_with_path

    module = build_model(cfg, "meta", train=True).init(torch.Generator())
    params = param_tree(module, cfg)

    def f32(_, t):
        return torch.empty(t.shape, dtype=torch.float32, device="meta")

    scalar = torch.empty((), dtype=torch.int32, device="meta")
    state = {"params": params,
             "opt": OptState(m=tree_map_with_path(f32, params),
                             v=tree_map_with_path(f32, params),
                             count=scalar),
             "step": scalar}
    if mesh is None:
        return state, None
    return state, state_specs(cfg, mesh, state)


def train_specs(cfg: ModelConfig, mesh) -> Dict[str, tuple]:
    """``{parameter name: spec}`` of the trainable module of ``cfg`` on
    ``mesh`` (``launch/shardings.module_specs`` of the whole's shapes, on
    meta tensors): what a process's shard, gradients and moments hold."""
    from .shardings import module_specs

    module = build_model(cfg, "meta", train=True).init(torch.Generator())
    return module_specs(cfg, mesh, module)


def init_train_state(params: torch.nn.Module) -> Dict[str, Any]:
    """The train state around trainable parameters (``build_model(cfg,
    device, train=True).init(gen)``): zero moments, step 0."""
    return {"params": params, "opt": init_opt_state(params),
            "step": torch.zeros((), dtype=torch.int32)}


def _on(device: torch.device, batch: Dict[str, Any]) -> Dict[str, Any]:
    """A host batch (numpy or tensors) on ``device``, token ids as int64."""
    out = {}
    for k, v in batch.items():
        t = torch.as_tensor(v)
        out[k] = (t.long() if k in ("tokens", "labels") else t).to(device)
    return out


def _batch_axes(cfg: ModelConfig, mesh) -> Tuple[str, ...]:
    """The axes the batch is cut over (``batch_specs``): every axis under
    ``pure_dp`` (without FSDP), else the DP axes."""
    if cfg.pure_dp and not cfg.fsdp:
        return tuple(mesh.axis_names)
    return dp_axes(mesh)


def _seq_partial_leaves(cfg: ModelConfig, mesh, names) -> Tuple[str, ...]:
    """Under sequence parallelism (``seq_shard_activations`` with TP over
    "model") the leaves each process uses on its sequence chunk alone, so
    that its gradient is its tokens' part: the norms' ``scale`` and
    ``bias`` and the MLP's ``b_down`` (added after the chunk's sum).  Empty
    without SP."""
    if not cfg.seq_shard_activations or cfg.pure_dp \
            or "model" not in mesh.axis_names \
            or mesh.axis_size("model") == 1:
        return ()
    return tuple(k for k in names
                 if k.rsplit(".", 1)[-1] in ("scale", "bias", "b_down"))


def _sum_seq_partial(grads: Dict[str, torch.Tensor], mesh: ProcessMesh,
                     names) -> Dict[str, torch.Tensor]:
    """The gradients of ``names`` (``_seq_partial_leaves``) summed over
    "model" in member order (gathered on the host): each model peer then
    holds the whole sequence's, the same bits on every peer, before
    ``_sync_grads`` sums over the DP axes."""
    for k in names:
        g = grads[k]
        grads[k] = member_sum(all_gather(mesh, g[None], ("model",), "cpu")[0],
                              g.device)
    return grads


def _sync_grads(grads: Dict[str, torch.Tensor], mesh: ProcessMesh,
                specs: Dict[str, tuple],
                axes: Optional[Tuple[str, ...]] = None
                ) -> Dict[str, torch.Tensor]:
    """Each process's gradients (of its own loss, the mean over its rows)
    as the gradient of the mean loss over every process's rows: summed over
    the batch's ``axes`` (``_batch_axes``; default the DP axes) the
    parameter is replicated on (gathered, added in member order), then
    divided by the number of processes they hold.  Under ``pure_dp`` that
    is every axis, "model" included: each process ran its own rows on
    whole weights (an expert shard's gradient, which its exchange's
    backward filled over its EP group, is summed over "model" alone).
    Otherwise never over "model" (the leaves SP uses on a sequence chunk
    are summed over it before, ``_sum_seq_partial``): a process's TP slice
    already holds its whole gradient (its model peers ran the same rows),
    and a leaf
    replicated over "model" (the norms, the router, ``q_norm``/``k_norm``,
    an encoder-decoder's ``enc_pos`` and ``dec_pos``, a leaf
    ``_drop_uneven`` keeps whole) reaches it whole and with the same bits
    on every peer, since each path into the TP region enters through
    ``models/tp.copy_in``, whose backward sums the peers' parts in member
    order.  An expert shard's gradient already holds the tokens of its EP
    group (the exchange's backward brought them): on the island, EP over
    every DP axis, that is every process's, so it is only divided; with
    EP over ``pod`` alone it is summed over ``data``, with no EP over
    every DP axis.  An FSDP leaf's gradient comes out of its gather's
    backward summed over the axes its spec adds (``models/fsdp.py``), which
    the spec holds: it is summed over the others alone.  Under ``pure_dp``
    with FSDP the batch goes over the DP axes alone: the model peers ran
    the same rows, hold the same gradients, and are summed over by no one
    (the gather's backward slices over "model").  ``grads`` is emptied as
    it goes: each gradient is freed once its synced form exists."""
    from .shardings import sharded_axes

    dp = dp_axes(mesh) if axes is None else axes
    n = mesh.axis_size(dp)
    out = {}
    for k in list(grads):
        g = grads.pop(k)
        held = sharded_axes(mesh, specs[k])
        over = tuple(a for a in dp if a not in held and mesh.axis_size(a) > 1)
        if over:
            # the copies land on the host and are added on the device one
            # at a time: the card never holds the group's copies at once
            g = member_sum(all_gather(mesh, g[None], over, "cpu")[0],
                           g.device)
        out[k] = g / n
    return out


def _global_metrics(metricses: list, mesh: ProcessMesh,
                    axes: Optional[Tuple[str, ...]] = None) -> Dict:
    """The reference's replicated metrics from each process's: per
    microbatch, ``loss`` and ``nll`` averaged over the processes of the
    batch's ``axes`` (default the DP axes; ``aux`` is the group's already)
    and ``ppl_proxy`` from that ``nll``; then the mean over microbatches."""
    dp = dp_axes(mesh) if axes is None else axes
    local = torch.stack([torch.stack([m["loss"], m["nll"]]).float()
                         for m in metricses])             # [n_mb, 2]
    loss, nll = (member_sum(all_gather(mesh, local[None], dp)[0])
                 / mesh.axis_size(dp)).unbind(-1)
    out = {"loss": loss, "nll": nll,
           "aux": torch.stack([m["aux"] for m in metricses]),
           "ppl_proxy": torch.exp(torch.clamp(nll, max=20.0))}
    return {k: v.mean(0) for k, v in out.items()}


def _process_rows(mesh: ProcessMesh, cfg: ModelConfig, batch: Dict,
                  n_mb: int) -> Dict:
    """This process's rows of the global host ``batch``: its rows
    (``batch_specs``) of each of the ``n_mb`` microbatches, in order, so
    that the accumulation's microbatch ``i`` holds what the reference's
    rank holds of the global microbatch ``i``."""
    from .shardings import batch_specs, shard_tensor

    dp = mesh.axis_size(_batch_axes(cfg, mesh))
    batch = {k: torch.as_tensor(v) for k, v in batch.items()}
    out = {}
    for k, v in batch.items():
        if not v.dim():
            out[k] = v
            continue
        if v.shape[0] % (n_mb * dp):
            raise ValueError(f"batch {k} of {v.shape[0]} rows does not split "
                             f"into {n_mb} microbatches over {dp} processes")
        mbs = v.reshape(n_mb, v.shape[0] // n_mb, *v.shape[1:])
        spec = batch_specs(mesh, {k: mbs[0]},
                           pure_dp=cfg.pure_dp and not cfg.fsdp)[k]
        out[k] = torch.cat([shard_tensor(mb, spec, mesh) for mb in mbs])
    return out


def _compress_pod_grads(grads: Dict[str, torch.Tensor], dist: DistContext,
                        specs: Optional[Dict[str, tuple]] = None):
    """int8 error-feedback gradient sync over the pod axis (the stateless
    form: the residual is dropped).  The gradients come in synced, the same
    on every member of a pod group, so the reference's quantize, gather,
    dequantize, sum and divide by the pod axis's size ``p`` is, on either
    mesh: quantize with the whole tensor's scale, dequantize, add ``p``
    equal copies in member order and divide by ``p``; nothing crosses the
    pod axis.  On a ``ProcessMesh`` (``specs``: each parameter's) a shard's
    scale is its tensor's largest magnitude over the processes that hold
    its slices, as the reference quantizes the whole."""
    from ..comm.collectives import _quantize_int8
    from .shardings import sharded_axes

    p = dist.mesh.axis_size(dist.slow_axis)
    out = {}
    for k, g in grads.items():
        amax = g.abs().amax()
        held = sharded_axes(dist.mesh, specs[k]) if specs is not None else ()
        if held:
            amax = all_gather(dist.mesh, amax.reshape(1, 1), held).amax()
        q, scale = _quantize_int8(g[None], amax[None])
        deq = q[0].to(g.dtype) * scale[0].to(g.dtype)
        out[k] = member_sum(deq.expand(p, *deq.shape)) / p
    return out


def make_train_step(cfg: ModelConfig, mesh, options: TrainOptions =
                    TrainOptions(), use_kernel: bool = True, device=None):
    """Returns ``train_step(state, batch) -> (state, metrics)``.

    ``batch``: {"tokens": [B, S], "labels": [B, S], extras...}, numpy or
    tensors, the global batch; moved to the device.  ``metrics``: the
    loss's (``loss``, ``nll``, ``aux``, ``ppl_proxy``) plus ``grad_norm``
    (before clipping) and ``lr``, as 0-dim tensors.  ``use_kernel=False``
    runs the plain versions of every kernel.  ``device`` defaults to the
    mesh's, else the card.

    On a ``ProcessMesh`` the state holds this process's shard and the step
    runs its rows of ``batch`` (of each microbatch); the gradients are
    synced (``_sync_grads``) before compression and AdamW, and the metrics
    and the gradient norm are the whole batch's and the whole tree's, the
    same bits in every process.
    """
    proc = isinstance(mesh, ProcessMesh)
    if device is not None:
        dev = resolve_device(device)
    else:
        dev = mesh.device if mesh is not None else resolve_device("cuda")
    model = build_model(cfg, dev, train=True)
    dist = make_dist_context(cfg, mesh, use_kernel=use_kernel) \
        if mesh is not None else None
    specs = train_specs(cfg, mesh) if proc else None
    seq_partial = _seq_partial_leaves(cfg, mesh, specs) if proc else ()
    lr_fn = cosine_schedule(options.peak_lr, options.warmup_steps,
                            options.total_steps)

    def grads_of(params, named, batch):
        with trace.span("train.forward_backward"):
            loss, metrics = model.loss(params, batch, dist, use_kernel)
            grads = torch.autograd.grad(loss, list(named.values()),
                                        allow_unused=True,
                                        materialize_grads=True)
        return dict(zip(named, grads)), \
            {k: v.detach() for k, v in metrics.items()}

    def step(state, batch):
        params = state["params"]
        named = dict(params.named_parameters())
        n_mb = options.microbatches
        if proc:
            batch = _process_rows(mesh, cfg, batch, n_mb)
        batch = _on(dev, batch)
        if n_mb > 1:
            # grad accumulation over sequential microbatches, in f32
            grads = {k: torch.zeros(p.shape, dtype=torch.float32,
                                    device=p.device)
                     for k, p in named.items()}
            metricses = []
            for i in range(n_mb):
                mb = {k: v.reshape(n_mb, v.shape[0] // n_mb,
                                   *v.shape[1:])[i] if v.dim() else v
                      for k, v in batch.items()}
                g, m = grads_of(params, named, mb)
                for k, a in grads.items():
                    a.add_(g[k].float() / n_mb)
                del g
                metricses.append(m)
        else:
            grads, m = grads_of(params, named, batch)
            metricses = [m]
        if proc:
            axes = _batch_axes(cfg, mesh)
            with trace.span("train.grad_sync"):
                grads = _sum_seq_partial(grads, mesh, seq_partial)
                grads = _sync_grads(grads, mesh, specs, axes)
            metrics = _global_metrics(metricses, mesh, axes)
        else:
            metrics = {k: torch.stack([m[k] for m in metricses]).mean(0)
                       for k in metricses[0]}
        if options.grad_compression and dist is not None \
                and dist.slow_axis is not None:
            grads = _compress_pod_grads(grads, dist, specs)
        lr = lr_fn(int(state["step"]))
        _, opt, gnorm = adamw_update(grads, state["opt"], named, lr,
                                     options.adamw, mesh if proc else None,
                                     specs)
        del grads
        metrics["grad_norm"] = gnorm
        metrics["lr"] = torch.tensor(lr, dtype=torch.float32)
        return {"params": params, "opt": opt,
                "step": state["step"] + 1}, metrics

    def train_step(state, batch):
        with trace.span("train.step", syncs=True):
            return step(state, batch)

    return train_step


# -- the training loop, on one process or one process per rank ------------------

def _train_loop(mesh, cfg: ModelConfig, params, data_cfg, options,
                steps: int, use_kernel: bool, ckpt_dir: Optional[str],
                each_step=None, device=None) -> dict:
    """The CLI's training steps on ``params`` (the whole module with no
    mesh or on a ``LocalMesh``, this process's shard on a ``ProcessMesh``)
    on ``device`` (default: the mesh's): each step's metrics and
    ``step_ms``, and on the card ``peak_gb``; or with ``ckpt_dir`` the
    ``Trainer``'s ``stopped_at``, ``preempted`` and last ``metrics``.
    ``each_step(i, run)``, when given, wraps the ``i``-th step call
    ``run()`` and returns its result."""
    from ..data import SyntheticLM

    dev = resolve_device(device) if device is not None else mesh.device
    proc = isinstance(mesh, ProcessMesh)
    step_fn = make_train_step(cfg, mesh, options, use_kernel=use_kernel,
                              device=dev)
    if each_step is not None:
        calls, inner = itertools.count(), step_fn

        def step_fn(state, batch):
            return each_step(next(calls), lambda: inner(state, batch))

    data = SyntheticLM(data_cfg, cfg)
    if ckpt_dir:
        from ..runtime import Trainer, TrainerConfig

        result = Trainer(
            TrainerConfig(total_steps=steps, ckpt_dir=ckpt_dir,
                          ckpt_every=max(steps // 4, 1)),
            train_step=step_fn, init_state=lambda: init_train_state(params),
            batches=data.batch, mesh=mesh,
            specs=train_specs(cfg, mesh) if proc else None).run()
        return {k: result[k] for k in ("stopped_at", "preempted",
                                       "metrics")}
    out = {"metrics": [], "step_ms": []}
    state = init_train_state(params)
    if dev.type == "cuda":
        torch.cuda.reset_peak_memory_stats(dev)
    for i in range(steps):
        batch = data.batch(i)
        t0 = time.perf_counter()
        state, metrics = step_fn(state, batch)
        if dev.type == "cuda":
            torch.cuda.synchronize(dev)
        out["step_ms"].append((time.perf_counter() - t0) * 1e3)
        out["metrics"].append({k: float(v) for k, v in metrics.items()})
    if dev.type == "cuda":
        out["peak_gb"] = torch.cuda.max_memory_allocated(dev) / 1e9
    return out


# -- one process per rank -------------------------------------------------------


def _train_rank(mesh, cfg: ModelConfig, holder: list, data_cfg,
                options: TrainOptions, steps: int, use_kernel: bool,
                ckpt_dir: Optional[str], handoff=None, hook=None) -> dict:
    """One rank of ``train_procs``: cut this process's trainable shard of
    the model in ``holder`` (emptied); with ``handoff`` wait until every
    rank holds its own and again until the parent has dropped the whole;
    then train (``_train_loop``).  ``hook(mesh, cfg, shards, train)``, when
    given, runs in place of the training: ``shards`` is a list holding the
    shard (the training takes it out), and ``train(each_step=None)`` is the
    training, which the hook must call once; its result goes back under
    ``"hook"``."""
    from ..convert import shard_module
    from .procs import RENDEZVOUS_TIMEOUT_S

    shards = [shard_module(holder.pop(), cfg, mesh, train=True)]
    gc.collect()
    if handoff is not None:
        handoff.wait(timeout=RENDEZVOUS_TIMEOUT_S)  # every rank holds its own
        handoff.wait(timeout=RENDEZVOUS_TIMEOUT_S)  # the parent dropped all
    trained = []

    def train(each_step=None) -> dict:
        trained.append(_train_loop(mesh, cfg, shards.pop(), data_cfg, options,
                                   steps, use_kernel, ckpt_dir, each_step))
        return trained[-1]

    if hook is None:
        return train()
    extra = hook(mesh, cfg, shards, train)
    if len(trained) != 1:
        raise RuntimeError(f"train_procs: the hook trained {len(trained)} "
                           f"times, not once")
    return {**trained[0], "hook": extra}


def train_procs(cfg: ModelConfig, params, data_cfg, mesh_shape,
                backend: str, device="cuda",
                options: TrainOptions = TrainOptions(), steps: int = 1,
                use_kernel: bool = True, ckpt_dir: Optional[str] = None,
                hook=None, **spawn_kw) -> dict:
    """Train on one process per rank of ``mesh_shape`` (pod, data, model):
    each process takes its trainable shard of ``params`` (a module or
    ``{name: tensor}`` of ``build_model(cfg, train=True)``, shared with it
    without a copy: CUDA IPC on the card), builds its moments and runs
    ``steps`` steps of ``SyntheticLM(data_cfg)``'s global batches, its rows
    of each.  With ``ckpt_dir`` the steps run through the ``Trainer``
    (resume, preemption and checkpoints over the processes).

    ``params`` may come in a one-element list, which is emptied: once every
    process holds its shard the parent drops the whole, as ``serve_procs``
    does (on the card ``card_used_gb`` reports the memory in use before and
    after).  Returns rank 0's ``metrics`` (one dict a step, the same in
    every process) and ``step_ms``, or the ``Trainer``'s ``stopped_at``,
    ``preempted`` and last ``metrics``; under ``torchrun`` (this process one
    rank) the same for this rank.  With ``hook`` (``_train_rank``),
    ``ranks`` holds each rank's hook result.  ``spawn_kw`` reaches
    ``procs.spawn`` (``init_method``, ``timeout``, ``join_timeout``)."""
    from .procs import spawn, spawn_with_handoff, under_torchrun
    from .shardings import named_params

    holder = params if isinstance(params, list) else [params]
    # the list the children unpickle; the spawned Process objects keep it
    named = [{k: v.detach() for k, v in named_params(holder.pop()).items()}]
    shape = tuple(mesh_shape)
    args = (shape, ("pod", "data", "model"), backend, device, cfg, named,
            data_cfg, options, steps, use_kernel, ckpt_dir)
    if under_torchrun():
        out, used = spawn(_train_rank, *args, None, hook, **spawn_kw), {}
    else:
        out, used = spawn_with_handoff(
            lambda handoff: spawn(_train_rank, *args, handoff, hook,
                                  **spawn_kw),
            named, int(np.prod(shape)), device)
    res = {k: v for k, v in out[0].items() if k != "hook"}
    if hook is not None:
        res["ranks"] = [o["hook"] for o in out]
    if used:
        res["card_used_gb"] = used
    return res


# -- CLI ----------------------------------------------------------------------

def _print_step(step: int, m: Dict[str, float], ms: float,
                tokens: int) -> None:
    print(f"step {step}: loss={m['loss']:.4f} nll={m['nll']:.4f} "
          f"aux={m['aux']:.4f} grad_norm={m['grad_norm']:.4f} "
          f"lr={m['lr']:.3e} {ms:.1f} ms ({tokens / ms * 1e3:.1f} tokens/s)")


def main(argv=None):
    from ..data import DataConfig

    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", required=True)
    ap.add_argument("--smoke", action="store_true",
                    help="use the reduced smoke config")
    ap.add_argument("--steps", type=int, default=50)
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--seq", type=int, default=64)
    ap.add_argument("--lr", type=float, default=3e-4)
    ap.add_argument("--mesh", default=None, metavar="POD,DATA[,MODEL]",
                    help="train on a local (POD, DATA, MODEL) mesh stacked "
                         "on the device (MODEL defaults to 1; the stacked "
                         "mesh keeps whole weights; with --procs, TP over "
                         "MODEL); default: no mesh")
    ap.add_argument("--procs", action="store_true",
                    help="train the --mesh on one process per rank")
    ap.add_argument("--backend", default=None, choices=("gloo", "nccl"),
                    help="the process groups' backend (with --procs): "
                         "gloo moves the exchange and the gradient sync "
                         "through host memory and lets ranks share one "
                         "card; nccl needs a card per rank")
    ap.add_argument("--init-method", default=None,
                    help="the process world's rendezvous (with --procs), "
                         "e.g. file:///tmp/store; default: a file store in "
                         "a fresh temporary directory")
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--n-layers", type=int, default=None,
                    help="override the config's depth")
    ap.add_argument("--microbatches", type=int, default=1)
    ap.add_argument("--pure-dp", action="store_true",
                    help="the config's pure_dp: weights replicated, the "
                         "batch cut over every mesh axis")
    ap.add_argument("--seq-shard", action="store_true",
                    help="the config's seq_shard_activations: the residual "
                         "stream on a sequence chunk between the TP regions "
                         "(with --procs and a MODEL above 1)")
    ap.add_argument("--fsdp", action="store_true",
                    help="the config's fsdp: each weight stored over the "
                         "intra-pod DP axes, gathered before use (with "
                         "--procs)")
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--ckpt-dir", default=None,
                    help="run through the Trainer, checkpointing here")
    args = ap.parse_args(argv)

    cfg = smoke_config(args.arch) if args.smoke else get_config(args.arch)
    if args.n_layers:
        cfg = dataclasses.replace(cfg, n_layers=args.n_layers)
    if args.pure_dp or args.seq_shard or args.fsdp:
        cfg = dataclasses.replace(
            cfg, pure_dp=cfg.pure_dp or args.pure_dp,
            seq_shard_activations=cfg.seq_shard_activations or args.seq_shard,
            fsdp=cfg.fsdp or args.fsdp)
    device = resolve_device(args.device)
    if args.procs and not (args.mesh and args.backend):
        ap.error("--procs needs --mesh and --backend")
    mesh = shape = None
    if args.mesh:
        try:
            shape = parse_mesh(args.mesh)
        except ValueError as e:
            ap.error(str(e))
        if not args.procs:
            mesh = make_mesh(shape, ("pod", "data", "model"), device)
    opts = TrainOptions(peak_lr=args.lr,
                        warmup_steps=max(args.steps // 10, 1),
                        total_steps=args.steps,
                        microbatches=args.microbatches)
    params = build_model(cfg, device, train=True).init(
        torch.Generator(device=device).manual_seed(args.seed))
    data_cfg = DataConfig(vocab=cfg.vocab, seq_len=args.seq,
                          global_batch=args.batch, seed=args.seed)
    where = f"{int(np.prod(shape))} processes ({args.backend}, {device})" \
        if args.procs else str(device)
    print(f"arch={cfg.name} layers={cfg.n_layers} mesh={shape} "
          f"batch={args.batch} seq={args.seq} on {where}")
    if args.procs:
        res = train_procs(cfg, [params], data_cfg, shape,
                          args.backend, args.device, opts, args.steps,
                          ckpt_dir=args.ckpt_dir,
                          init_method=args.init_method)
    else:
        res = _train_loop(mesh, cfg, params, data_cfg, opts, args.steps,
                          True, args.ckpt_dir, device=device)
    if args.ckpt_dir:
        print(f"finished at step {res['stopped_at']} "
              f"loss={res['metrics'].get('loss'):.4f} "
              f"preempted={res['preempted']}")
        return
    for step, (m, ms) in enumerate(zip(res["metrics"], res["step_ms"])):
        _print_step(step, m, ms, args.batch * args.seq)
    if "card_used_gb" in res:
        print("card memory in use (GB): " + ", ".join(
            f"{k} {v:.2f}" for k, v in res["card_used_gb"].items()))
    if "peak_gb" in res:
        print(f"peak device memory {res['peak_gb']:.2f} GB")


if __name__ == "__main__":
    main()
