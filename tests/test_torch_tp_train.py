"""Training with tensor parallelism over "model" on one process per rank:
the smoke archs and meshes of ``test_torch_tp_serve.py`` in f32, through
``train_procs``, against the reference's ``make_train_step`` on 4, 8, 6
and 12 fake devices (its GSPMD TP over "model"):

* llama3.2-1b on (1, 2, 2): dense TP, the tied vocabulary-parallel
  embedding, head and cross entropy;
* megatron-moe-32e on (2, 2, 2): the island, the experts' ``d_ff`` over
  "model"; its steps run through the ``Trainer``, whose checkpoint the test
  restores;
* mixtral-8x7b on (1, 3, 2) (no EP) and (2, 3, 2) (EP over ``pod``).

Two AdamW steps of 12 x 16 tokens at ``test_torch_train.py``'s
tolerances: metrics within a relative 1e-5, each step's gradients gathered
from the processes within a relative norm of 1e-4, parameters after the
last step within 1e-5 of each tensor's largest value.  Every gradient of a
leaf replicated over "model" (norms, the router, the MLP's ``b_down``) is
bit for bit the same on a DP rank's model peers.  The (2, 2, 2) checkpoint
restores bit for bit with no mesh and on a ``LocalMesh``; ``train --procs
--mesh 2,2,2`` on the command line trains as ``train_procs`` does.  One
spawn a mesh; the reference runs once, in one subprocess on 12 fake
devices.
"""

import dataclasses
import os
import re
import subprocess
import sys

import numpy as np
import pytest
import torch
from conftest import REPO, SRC, run_subprocess
from test_torch_train import (METRICS, OPTIONS, STEPS, _check_against_ref,
                              _tree, _unflatten)

from repro_torch.checkpoint import restore_checkpoint
from repro_torch.configs import smoke_config
from repro_torch.convert import from_jax_params
from repro_torch.data import DataConfig
from repro_torch.launch import train as pt_train
from repro_torch.launch.mesh import make_mesh

AXES = ("pod", "data", "model")
BATCH, SEQ = 12, 16
CASES = {"llama": ("llama3.2-1b", (1, 2, 2)),
         "megatron": ("megatron-moe-32e", (2, 2, 2)),
         "mixtral_none": ("mixtral-8x7b", (1, 3, 2)),
         "mixtral_pod": ("mixtral-8x7b", (2, 3, 2))}
CKPT_CASE = "megatron"

_JAX_SIDE = """
import dataclasses, numpy as np, jax, jax.numpy as jnp
from repro.configs import smoke_config
from repro.data import DataConfig, SyntheticLM
from repro.launch import train as T
from repro.launch.mesh import make_mesh
from repro.models import build_model
from repro.optim import init_opt_state

real_update = T.adamw_update

def spy(grads, opt, params, lr, cfg):
    p, o, n = real_update(grads, opt, params, lr, cfg)
    return p, o, {"norm": n, "grads": grads}

T.adamw_update = spy   # the step reads its gradients out through grad_norm

def flat(tree, prefix=""):
    if isinstance(tree, dict):
        out = {}
        for k, v in tree.items():
            out.update(flat(v, f"{prefix}{k}."))
        return out
    if isinstance(tree, (list, tuple)):
        out = {}
        for i, v in enumerate(tree):
            out.update(flat(v, f"{prefix}{i}."))
        return out
    return {prefix[:-1]: np.asarray(tree)}

out = {}
for name, (arch, shape) in CASES.items():
    cfg = dataclasses.replace(smoke_config(arch), compute_dtype="float32")
    params0 = build_model(cfg).init(jax.random.PRNGKey(0))
    out.update({f"{name}/init/{k}": v for k, v in flat(params0).items()})
    data = SyntheticLM(DataConfig(vocab=cfg.vocab, seq_len=SEQ,
                                  global_batch=BATCH), cfg)
    mesh = make_mesh(shape, ("pod", "data", "model"))
    step, _, state_sh, batch_fn = T.make_train_step(
        cfg, mesh, T.TrainOptions(**OPTIONS))
    state = jax.device_put({"params": params0,
                            "opt": init_opt_state(params0),
                            "step": jnp.zeros((), jnp.int32)}, state_sh)
    for i in range(STEPS):
        batch = {k: jnp.asarray(v) for k, v in data.batch(i).items()}
        state, m = step(state, jax.device_put(batch, batch_fn(batch)))
        gn = m.pop("grad_norm")
        m["grad_norm"] = gn["norm"]
        for k, v in m.items():
            out[f"{name}/m{i}/{k}"] = np.asarray(v)
        for k, v in flat(gn["grads"]).items():
            out[f"{name}/g{i}/{k}"] = v
    for k, v in flat(state["params"]).items():
        out[f"{name}/p/{k}"] = v
np.savez(OUT, **out)
print("JAX_SIDE_OK")
"""


@pytest.fixture(scope="module")
def ref(tmp_path_factory):
    path = os.path.join(tmp_path_factory.mktemp("tp_train"), "ref.npz")
    out = run_subprocess(
        f"CASES = {CASES!r}\nBATCH, SEQ, STEPS = {BATCH}, {SEQ}, {STEPS}\n"
        f"OPTIONS = {OPTIONS!r}\nOUT = {path!r}\n" + _JAX_SIDE,
        n_devices=12)
    assert "JAX_SIDE_OK" in out
    return dict(np.load(path))


def _cfg(name):
    return dataclasses.replace(smoke_config(CASES[name][0]),
                               compute_dtype="float32")


def _data_cfg(cfg):
    return DataConfig(vocab=cfg.vocab, seq_len=SEQ, global_batch=BATCH)


def _module(ref, name):
    return from_jax_params(_unflatten(_tree(ref, f"{name}/init/")),
                           _cfg(name), device="cpu", train=True)


def _gather(mesh, specs, named):
    """The whole of each of this process's ``named`` shards (collective);
    on rank 0 only."""
    from repro_torch.launch.shardings import gather_tensor

    whole = {k: gather_tensor(v.detach(), specs[k], mesh)
             for k, v in named.items()}
    return whole if mesh.rank == 0 else None


def _hook(mesh, cfg, shards, train):
    """Train, reading each step's gradients where AdamW gets them and each
    step's metrics; gather them and the final parameters on rank 0; keep
    this process's gradients of the leaves replicated over "model"."""
    specs = pt_train.train_specs(cfg, mesh)
    module, seen, metrics = shards[0], [], []
    real = pt_train.adamw_update

    def spy(grads, *args):
        seen.append({k: g.detach().clone() for k, g in grads.items()})
        return real(grads, *args)

    def each_step(i, run):
        state, m = run()
        metrics.append({k: float(v) for k, v in m.items()})
        return state, m

    pt_train.adamw_update = spy
    try:
        train(each_step)
    finally:
        pt_train.adamw_update = real
    replicated = [k for k, spec in specs.items()
                  if not any("model" in ((e,) if isinstance(e, str) else
                                         (e or ())) for e in spec)]
    return {"coords": mesh.rank_coords,
            "sharded": sorted(set(specs) - set(replicated)),
            "replicated": [{k: g[k].numpy() for k in replicated}
                           for g in seen],
            "run": (metrics, [_gather(mesh, specs, g) for g in seen],
                    _gather(mesh, specs, dict(module.named_parameters())))}


@pytest.fixture(scope="module")
def procs(ref, tmp_path_factory):
    out = {}
    for name, (_, shape) in CASES.items():
        cfg = _cfg(name)
        rdv = tmp_path_factory.mktemp(f"rdv_{name}") / "store"
        ckpt = str(tmp_path_factory.mktemp("ckpt")) if name == CKPT_CASE \
            else None
        res = pt_train.train_procs(
            cfg, [_module(ref, name)], _data_cfg(cfg), shape, "gloo", "cpu",
            pt_train.TrainOptions(**OPTIONS), STEPS, ckpt_dir=ckpt,
            hook=_hook, init_method=f"file://{rdv}", timeout=60.0,
            join_timeout=240)
        out[name] = {"ranks": res["ranks"], "ckpt": ckpt, "res": res}
    return out


@pytest.mark.parametrize("name", list(CASES))
def test_processes_train_as_the_reference(ref, procs, name):
    ranks = procs[name]["ranks"]
    assert len(ranks) == int(np.prod(CASES[name][1]))
    # the TP leaves are there: attention, the FFN or the experts, the
    # vocabulary
    sharded = ranks[0]["sharded"]
    for leaf in ("embed", "blocks.0.attn.wq", "blocks.0.attn.wo"):
        assert leaf in sharded
    ffn = "moe" if _cfg(name).moe is not None else "mlp"
    assert f"blocks.0.{ffn}.w_down" in sharded
    _check_against_ref(ref, name, ranks[0]["run"])


@pytest.mark.parametrize("name", list(CASES))
def test_replicated_gradients_identical_on_model_peers(procs, name):
    shape = CASES[name][1]
    by = {tuple(r["coords"]): r for r in procs[name]["ranks"]}
    for pod in range(shape[0]):
        for data in range(shape[1]):
            first = by[(pod, data, 0)]["replicated"]
            assert len(first) == STEPS and first[0]
            for m in range(1, shape[2]):
                for a, b in zip(first, by[(pod, data, m)]["replicated"]):
                    assert set(a) == set(b)
                    for k in a:
                        assert np.array_equal(a[k], b[k]), k


@pytest.mark.parametrize("where", ["none", "local_mesh"])
def test_tp_checkpoint_restores_bit_for_bit(procs, where):
    """The Trainer's last checkpoint of the (2, 2, 2) run holds the whole
    parameters: restored with no mesh and on a stacked ``LocalMesh``, they
    are bit for bit the processes' final parameters gathered."""
    cfg = _cfg(CKPT_CASE)
    assert procs[CKPT_CASE]["res"]["stopped_at"] == STEPS
    from repro_torch.models import build_model

    state = pt_train.init_train_state(build_model(cfg, "cpu", train=True)
                                      .init(torch.Generator().manual_seed(1)))
    mesh = make_mesh(CASES[CKPT_CASE][1], AXES, device="cpu") \
        if where == "local_mesh" else None
    state, step = restore_checkpoint(procs[CKPT_CASE]["ckpt"], state,
                                     mesh=mesh)
    assert step == STEPS
    _, _, final = procs[CKPT_CASE]["ranks"][0]["run"]
    got = dict(state["params"].named_parameters())
    assert set(got) == set(final)
    for k, v in final.items():
        assert torch.equal(got[k].detach(), v), k


def _cli(args, procs, tmp_path):
    extra = ["--procs", "--backend", "gloo", "--init-method",
             f"file://{tmp_path / 'store'}"] if procs else []
    proc = subprocess.run(
        [sys.executable, "-m", "repro_torch.launch.train", *args, *extra],
        capture_output=True, text=True, env=dict(os.environ, PYTHONPATH=SRC),
        cwd=REPO, timeout=300)
    assert proc.returncode == 0, proc.stderr[-4000:]
    return proc.stdout


def test_train_cli_with_tp_on_processes(tmp_path):
    """``train --procs --mesh 2,2,2`` (8 gloo processes, the smoke config
    in bf16) prints the steps ``train_procs`` gives on the same model, data
    and options."""
    from repro_torch.models import build_model

    args = ["--arch", "megatron-moe-32e", "--smoke", "--device", "cpu",
            "--mesh", "2,2,2", "--batch", "8", "--seq", "16", "--steps",
            "2"]
    got = _cli(args, True, tmp_path)
    assert "on 8 processes (gloo, cpu)" in got
    cfg = smoke_config("megatron-moe-32e")
    params = build_model(cfg, "cpu", train=True).init(
        torch.Generator(device="cpu").manual_seed(0))
    res = pt_train.train_procs(
        cfg, [params], DataConfig(vocab=cfg.vocab, seq_len=16,
                                  global_batch=8, seed=0),
        (2, 2, 2), "gloo", "cpu",
        pt_train.TrainOptions(peak_lr=3e-4, warmup_steps=1, total_steps=2),
        2, init_method=f"file://{tmp_path / 'api'}", timeout=60.0,
        join_timeout=240)

    def steps(text):
        return [re.findall(r"(?:loss|nll|aux|grad_norm)=[-\d.e+]+", line)
                for line in text.splitlines() if line.startswith("step ")]

    want = [[f"{k}={m[k]:.4f}" for k in ("loss", "nll", "aux",
                                          "grad_norm")]
            for m in res["metrics"]]
    assert steps(got) == want


def test_metrics_are_the_whole_batch(procs):
    """Every case's step metrics are finite and the loss falls from a value
    near ln(V) (random weights)."""
    for name in CASES:
        metrics, _, _ = procs[name]["ranks"][0]["run"]
        for m in metrics:
            assert all(np.isfinite(m[k]) for k in METRICS)
        assert abs(metrics[0]["nll"] - np.log(_cfg(name).vocab)) < 1.0
