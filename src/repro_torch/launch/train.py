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
rank.

Run directly to train on the card (or ``--device cpu``):

    PYTHONPATH=src python -m repro_torch.launch.train \\
        --arch megatron-moe-32e --n-layers 2 --mesh 2,16 --batch 32 \\
        --seq 512 --steps 4
    PYTHONPATH=src python -m repro_torch.launch.train \\
        --arch megatron-moe-32e --smoke --device cpu --mesh 2,2 --batch 8 \\
        --seq 32 --steps 20

``--ckpt-dir`` runs the steps through the fault-tolerant ``Trainer``
(resume, preemption, checkpoints); without it no checkpoint is written (at
full width one holds 55 GB).
"""

from __future__ import annotations

import argparse
import dataclasses
import time
from typing import Any, Dict, Optional

import torch

from ..configs import ModelConfig, get_config, smoke_config
from ..models import DistContext, build_model, choose_ep_axes
from ..models.sharding import MeshRules
from ..optim import AdamWConfig, OptState, adamw_update, cosine_schedule, \
    init_opt_state
from .mesh import (LocalMesh, ProcessMesh, dp_axes, make_mesh,
                   resolve_device, slow_axis)

__all__ = ["TrainOptions", "make_dist_context", "make_train_step",
           "init_train_state", "make_rules", "make_train_state_shapes"]


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
    return DistContext(
        mesh=mesh,
        dp_axes=dp_axes(mesh),
        slow_axis=slow_axis(mesh),
        ep_axes=choose_ep_axes(cfg, mesh),
        a2a_impl=impl,
        plan=plan,
        use_kernel=use_kernel,
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
    "step"}``, the moments f32 beside each parameter.  Specs only: a
    training step over processes is not ported yet."""
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


def _compress_pod_grads(grads: Dict[str, torch.Tensor], dist: DistContext):
    """int8 error-feedback gradient sync over the pod axis (the stateless
    form: the residual is dropped).  Every rank holds the same gradient, so
    this is the reference's quantize, gather, dequantize, sum and divide by
    the pod axis's size on the stacked copies."""
    from ..comm.collectives import ef_compressed_psum

    mesh = dist.mesh.sub((dist.slow_axis,))
    p = mesh.size
    out = {}
    for k, g in grads.items():
        total, _ = ef_compressed_psum(mesh, g.expand(p, *g.shape),
                                      dist.slow_axis)
        out[k] = total[0] / p
    return out


def make_train_step(cfg: ModelConfig, mesh: Optional[LocalMesh],
                    options: TrainOptions = TrainOptions(),
                    use_kernel: bool = True, device=None):
    """Returns ``train_step(state, batch) -> (state, metrics)``.

    ``batch``: {"tokens": [B, S], "labels": [B, S], extras...}, numpy or
    tensors; moved to the device.  ``metrics``: the loss's (``loss``,
    ``nll``, ``aux``, ``ppl_proxy``) plus ``grad_norm`` (before clipping)
    and ``lr``, as 0-dim tensors.  ``use_kernel=False`` runs the plain
    versions of every kernel.  ``device`` defaults to the mesh's, else the
    card.
    """
    if isinstance(mesh, ProcessMesh):
        raise ValueError("a training step over processes is not ported: "
                         "train on a LocalMesh")
    if device is not None:
        dev = resolve_device(device)
    else:
        dev = mesh.device if mesh is not None else resolve_device("cuda")
    model = build_model(cfg, dev, train=True)
    dist = make_dist_context(cfg, mesh, use_kernel=use_kernel) \
        if mesh is not None else None
    lr_fn = cosine_schedule(options.peak_lr, options.warmup_steps,
                            options.total_steps)

    def grads_of(params, named, batch):
        loss, metrics = model.loss(params, batch, dist, use_kernel)
        grads = torch.autograd.grad(loss, list(named.values()),
                                    allow_unused=True,
                                    materialize_grads=True)
        return dict(zip(named, grads)), \
            {k: v.detach() for k, v in metrics.items()}

    def train_step(state, batch):
        params = state["params"]
        named = dict(params.named_parameters())
        batch = _on(dev, batch)
        n_mb = options.microbatches
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
            metrics = {k: torch.stack([m[k] for m in metricses]).mean(0)
                       for k in metricses[0]}
        else:
            grads, metrics = grads_of(params, named, batch)
        if options.grad_compression and dist is not None \
                and dist.slow_axis is not None:
            grads = _compress_pod_grads(grads, dist)
        lr = lr_fn(int(state["step"]))
        _, opt, gnorm = adamw_update(grads, state["opt"], named, lr,
                                     options.adamw)
        del grads
        metrics["grad_norm"] = gnorm
        metrics["lr"] = torch.tensor(lr, dtype=torch.float32)
        return {"params": params, "opt": opt,
                "step": state["step"] + 1}, metrics

    return train_step


# -- CLI ----------------------------------------------------------------------

def main(argv=None):
    from ..data import DataConfig, SyntheticLM

    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", required=True)
    ap.add_argument("--smoke", action="store_true",
                    help="use the reduced smoke config")
    ap.add_argument("--steps", type=int, default=50)
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--seq", type=int, default=64)
    ap.add_argument("--lr", type=float, default=3e-4)
    ap.add_argument("--mesh", default=None, metavar="POD,DATA",
                    help="train on a local (POD, DATA, 1) mesh stacked on "
                         "the device; default: no mesh")
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--n-layers", type=int, default=None,
                    help="override the config's depth")
    ap.add_argument("--microbatches", type=int, default=1)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--ckpt-dir", default=None,
                    help="run through the Trainer, checkpointing here")
    args = ap.parse_args(argv)

    cfg = smoke_config(args.arch) if args.smoke else get_config(args.arch)
    if args.n_layers:
        cfg = dataclasses.replace(cfg, n_layers=args.n_layers)
    device = resolve_device(args.device)
    mesh = None
    if args.mesh:
        pod, data = (int(v) for v in args.mesh.split(","))
        mesh = make_mesh((pod, data, 1), ("pod", "data", "model"), device)
    opts = TrainOptions(peak_lr=args.lr,
                        warmup_steps=max(args.steps // 10, 1),
                        total_steps=args.steps,
                        microbatches=args.microbatches)
    step_fn = make_train_step(cfg, mesh, opts, device=device)
    model = build_model(cfg, device, train=True)

    def init_state():
        gen = torch.Generator(device=device).manual_seed(args.seed)
        return init_train_state(model.init(gen))

    data = SyntheticLM(DataConfig(vocab=cfg.vocab, seq_len=args.seq,
                                  global_batch=args.batch, seed=args.seed),
                       cfg)
    print(f"arch={cfg.name} layers={cfg.n_layers} mesh={mesh and mesh.shape}"
          f" batch={args.batch} seq={args.seq} on {device}")
    if args.ckpt_dir:
        from ..runtime import Trainer, TrainerConfig

        trainer = Trainer(
            TrainerConfig(total_steps=args.steps, ckpt_dir=args.ckpt_dir,
                          ckpt_every=max(args.steps // 4, 1)),
            train_step=step_fn, init_state=init_state, batches=data.batch)
        result = trainer.run()
        print(f"finished at step {result['stopped_at']} "
              f"loss={result['metrics'].get('loss'):.4f} "
              f"preempted={result['preempted']}")
        return
    state = init_state()
    if device.type == "cuda":
        torch.cuda.reset_peak_memory_stats(device)
    for step in range(args.steps):
        t0 = time.perf_counter()
        state, metrics = step_fn(state, data.batch(step))
        if device.type == "cuda":
            torch.cuda.synchronize(device)
        dt = time.perf_counter() - t0
        print(f"step {step}: loss={float(metrics['loss']):.4f} "
              f"nll={float(metrics['nll']):.4f} "
              f"aux={float(metrics['aux']):.4f} "
              f"grad_norm={float(metrics['grad_norm']):.4f} "
              f"lr={float(metrics['lr']):.3e} {dt * 1e3:.1f} ms "
              f"({args.batch * args.seq / dt:.1f} tokens/s)")
    if device.type == "cuda":
        print(f"peak device memory "
              f"{torch.cuda.max_memory_allocated(device) / 1e9:.2f} GB")


if __name__ == "__main__":
    main()
