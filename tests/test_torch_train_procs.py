"""The training step on one process per rank: 4 gloo processes of a (pod 2,
data 2, model 1) ``ProcessMesh``, each holding its batch rows and its shard
of the state, against the reference's ``make_train_step`` on 4 fake devices
and against the port's stacked ``LocalMesh`` step.

The reference runs once, in one subprocess: ``test_torch_train.py``'s
program over its mesh cases (``mesh``, ``mb2``, ``gc``, ``noremat`` and
``bf16ce``, imported from there with its tolerances and its checks), then a
dense smoke arch (llama3.2-1b, every leaf replicated over the DP axes).
The processes run through ``train_procs`` (the parent's model cut in each
process) with a per-rank hook that runs the cases and gathers each step's
gradients and the final parameters on rank 0.

* Every case within ``test_torch_train.py``'s tolerances of the reference:
  metrics within a relative 1e-5, gathered gradients within a relative norm
  of 1e-4, parameters after the last step within 1e-5 of each tensor's
  largest value; ``gc`` keeps its one-quantum rule.
* The ``mesh`` case against the port's ``LocalMesh`` step: metrics within
  a relative 1e-6, gradients within a relative norm of 1e-5, parameters
  within 1e-6.
* The ``Trainer`` over the processes: 2 steps, a checkpoint written by 4
  processes and a resume to 4 land within 1e-6 of 4 unbroken steps; that
  checkpoint restores bit for bit with no mesh, and on a ``LocalMesh`` 2
  more steps land within 1e-5 of the processes' unbroken run; a checkpoint
  written by one process restores bit for bit into every process's shard; a
  preemption that one process sees stops all four at the same step.
* ``train --procs`` from the command line trains as ``train --mesh``.
* The pod axis's int8 compression of synced gradients sends nothing and
  gives, bit for bit, ``ef_compressed_psum`` over the stacked copies.
"""

import dataclasses
import functools
import os
import re
import shutil
import subprocess
import sys

import numpy as np
import pytest
import torch
from conftest import REPO, SRC, run_subprocess
from test_torch_train import (_JAX_SIDE, ARCH, BATCH, CASES, METRICS,
                              OPTIONS, SEQ, STEPS, _check_against_ref, _tree,
                              _unflatten)

from repro_torch.checkpoint import restore_checkpoint, save_checkpoint
from repro_torch.configs import smoke_config
from repro_torch.convert import from_jax_params
from repro_torch.data import DataConfig, SyntheticLM
from repro_torch.launch import train as pt_train
from repro_torch.launch.mesh import make_mesh
from repro_torch.runtime import Trainer, TrainerConfig

SHAPE = (2, 2, 1)
AXES = ("pod", "data", "model")
PROC_CASES = ("mesh", "mb2", "gc", "noremat", "bf16ce")
DENSE = "llama3.2-1b"
TRAINER_OPTIONS = {"peak_lr": 5e-3, "warmup_steps": 2, "total_steps": 4}

_DENSE_SIDE = """
dcfg = dataclasses.replace(smoke_config(DENSE), compute_dtype="float32")
dparams = build_model(dcfg).init(jax.random.PRNGKey(0))
out = {f"init/{k}": v for k, v in flat(dparams).items()}
ddata = SyntheticLM(DataConfig(vocab=dcfg.vocab, seq_len=SEQ,
                               global_batch=BATCH), dcfg)
mesh = make_mesh((2, 2, 1), ("pod", "data", "model"))
step, _, state_sh, batch_fn = T.make_train_step(dcfg, mesh,
                                                T.TrainOptions(**OPTIONS))
state = jax.device_put({"params": dparams, "opt": init_opt_state(dparams),
                        "step": jnp.zeros((), jnp.int32)}, state_sh)
for i in range(STEPS):
    batch = {k: jnp.asarray(v) for k, v in ddata.batch(i).items()}
    state, m = step(state, jax.device_put(batch, batch_fn(batch)))
    gn = m.pop("grad_norm")
    m["grad_norm"] = gn["norm"]
    for k, v in m.items():
        out[f"dense/m{i}/{k}"] = np.asarray(v)
    for k, v in flat(gn["grads"]).items():
        out[f"dense/g{i}/{k}"] = v
for k, v in flat(state["params"]).items():
    out[f"dense/p/{k}"] = v
np.savez(OUT_DENSE, **out)
print("DENSE_SIDE_OK")
"""


def _cfg(arch=ARCH, **over):
    return dataclasses.replace(smoke_config(arch), compute_dtype="float32",
                               **over)


def _data(cfg):
    return SyntheticLM(DataConfig(vocab=cfg.vocab, seq_len=SEQ,
                                  global_batch=BATCH), cfg)


@pytest.fixture(scope="module")
def refs(tmp_path_factory):
    """The reference's mesh cases and its dense run, in one subprocess on 4
    fake devices."""
    d = tmp_path_factory.mktemp("train_procs")
    out, dense = str(d / "ref.npz"), str(d / "dense.npz")
    cases = {k: CASES[k] for k in PROC_CASES}
    code = (f"ARCH = {ARCH!r}\nDENSE = {DENSE!r}\n"
            f"BATCH, SEQ, STEPS = {BATCH}, {SEQ}, {STEPS}\n"
            f"CASES = {cases!r}\nOPTIONS = {OPTIONS!r}\nOUT = {out!r}\n"
            f"OUT_DENSE = {dense!r}\n" + _JAX_SIDE + _DENSE_SIDE)
    text = run_subprocess(code, n_devices=4)
    assert "JAX_SIDE_OK" in text and "DENSE_SIDE_OK" in text
    return dict(np.load(out)), dict(np.load(dense))


def _module(ref, cfg):
    return from_jax_params(_unflatten(_tree(ref, "init/")), cfg,
                           device="cpu", train=True)


def _fresh(named, cfg):
    """A trainable module of ``cfg`` holding copies of ``named``."""
    from repro_torch.convert import recast

    return recast({k: v.detach().clone() for k, v in named.items()}, cfg,
                  train=True)


def _gather(mesh, cfg, named):
    """The whole of every tensor of this process's shard ``named`` (keyed by
    parameter name, or ``<prefix>/<name>``; collective); on rank 0 only,
    else None."""
    from repro_torch.launch.shardings import gather_tensor

    specs = pt_train.train_specs(cfg, mesh)
    whole = {k: gather_tensor(v.detach(), specs[k.rsplit("/", 1)[-1]], mesh)
             for k, v in named.items()}
    return whole if mesh.rank == 0 else None


def _state_tensors(state):
    out = {f"p/{k}": v for k, v in state["params"].named_parameters()}
    out.update({f"m/{k}": v for k, v in state["opt"].m.items()})
    out.update({f"v/{k}": v for k, v in state["opt"].v.items()})
    return out


def _run_case(mesh, cfg, module, opts, step_fn=None):
    """STEPS steps of ``module`` on the global batches: the metrics, each
    step's gradients as AdamW got them and the final parameters, gathered
    on rank 0."""
    seen = []
    real = pt_train.adamw_update

    def spy(grads, *args):
        seen.append({k: g.detach().clone() for k, g in grads.items()})
        return real(grads, *args)

    pt_train.adamw_update = spy
    try:
        if step_fn is None:
            step = pt_train.make_train_step(cfg, mesh, opts, device="cpu")
            state, data, metrics = pt_train.init_train_state(module), \
                _data(cfg), []
            for i in range(STEPS):
                state, m = step(state, data.batch(i))
                metrics.append({k: float(v) for k, v in m.items()})
        else:
            metrics = step_fn()["metrics"]
    finally:
        pt_train.adamw_update = real
    grads = [_gather(mesh, cfg, g) for g in seen]
    final = _gather(mesh, cfg, dict(module.named_parameters()))
    return (metrics, grads, final) if mesh.rank == 0 else None


def _trainers(mesh, cfg, init, root, reverse):
    """The Trainer over the processes: 4 unbroken steps (``a``); 2 steps
    and a resume to 4 (``b``, its step-2 checkpoint written by the 4
    processes); a restore of ``reverse`` (a one-process checkpoint) into
    this process's shard; a preemption seen by rank 1 alone."""
    specs = pt_train.train_specs(cfg, mesh)
    step = pt_train.make_train_step(cfg, mesh, pt_train.TrainOptions(
        **TRAINER_OPTIONS), device="cpu")
    data = _data(cfg)

    def init_state():
        return pt_train.init_train_state(_fresh(init, cfg))

    def run(ckpt, total, every, batches=data.batch, keep=None):
        t = Trainer(TrainerConfig(total_steps=total, ckpt_dir=ckpt,
                                  ckpt_every=every), step, init_state,
                    batches, mesh=mesh, specs=specs)
        if keep is not None:
            keep.append(t)
        return t.run()

    out = {}
    a = run(f"{root}/a", 4, 100)
    b2 = run(f"{root}/b", 2, 2)
    out["b2"] = _gather(mesh, cfg, _state_tensors(b2["state"]))
    b = run(f"{root}/b", 4, 100)
    out["stopped"] = (b["stopped_at"], int(b["state"]["step"]))
    fa, fb = (dict(r["state"]["params"].named_parameters()) for r in (a, b))
    out["resume_err"] = max(float((fb[k] - fa[k]).abs().max()
                                  / fa[k].abs().max()) for k in fa)
    out["a"] = _gather(mesh, cfg, fa)

    state = init_state()
    restore_checkpoint(reverse, state, mesh=mesh, specs=specs)
    out["reverse"] = _gather(mesh, cfg, _state_tensors(state))

    trainers = []

    def batches(i):
        if mesh.rank == 1 and i == 1:
            trainers[0]._preempted = True    # as its SIGTERM handler does
        return data.batch(i)

    p = run(f"{root}/p", 6, 100, batches, trainers)
    out["preempted"] = (p["preempted"], p["stopped_at"],
                        int(p["state"]["step"]))
    return out


def _rank_hook(mesh, cfg, shards, train, dense, root, reverse):
    """Every case on this process: ``mesh`` through ``train_procs``' own
    loop (``train()``), the others, the dense arch and the Trainer on fresh
    shards of the same initial parameters."""
    from repro_torch.convert import shard_module

    init = {k: v.detach().clone() for k, v in
            shards[0].named_parameters()}
    module = shards[0]
    out = {"mesh": _run_case(mesh, cfg, module, None, train)}
    for case in PROC_CASES[1:]:
        _, over, opt_over = CASES[case]
        c = dataclasses.replace(cfg, **over)
        out[case] = _run_case(mesh, c, _fresh(init, c), pt_train.TrainOptions(
            **OPTIONS, **opt_over))
    dcfg = _cfg(DENSE)
    out["dense"] = _run_case(mesh, dcfg, shard_module(
        dense, dcfg, mesh, train=True), pt_train.TrainOptions(**OPTIONS))
    out["trainer"] = _trainers(mesh, cfg, init, root, reverse)
    return out


@pytest.fixture(scope="module")
def reverse(refs, tmp_path_factory):
    """A checkpoint written by one process: the LocalMesh state after one
    step (nonzero moments)."""
    cfg = _cfg()
    root = str(tmp_path_factory.mktemp("reverse"))
    mesh = make_mesh(SHAPE, AXES, device="cpu")
    step = pt_train.make_train_step(cfg, mesh, pt_train.TrainOptions(
        **TRAINER_OPTIONS), device="cpu")
    state, _ = step(pt_train.init_train_state(_module(refs[0], cfg)),
                    _data(cfg).batch(0))
    save_checkpoint(root, 1, state)
    return root, {k: v.detach().clone()
                  for k, v in _state_tensors(state).items()}


@pytest.fixture(scope="module")
def procs(refs, reverse, tmp_path_factory):
    cfg = _cfg()
    root = str(tmp_path_factory.mktemp("ckpt"))
    rdv = tmp_path_factory.mktemp("rdv") / "store"
    dense = {k: v.detach() for k, v in
             _module(refs[1], _cfg(DENSE)).named_parameters()}
    holder = [_module(refs[0], cfg)]
    res = pt_train.train_procs(
        cfg, holder, DataConfig(vocab=cfg.vocab, seq_len=SEQ,
                                global_batch=BATCH), SHAPE, "gloo", "cpu",
        pt_train.TrainOptions(**OPTIONS), STEPS,
        hook=functools.partial(_rank_hook, dense=dense, root=root,
                               reverse=reverse[0]),
        init_method=f"file://{rdv}", timeout=60.0, join_timeout=240)
    return {**res["ranks"][0], "ranks": res["ranks"], "holder": holder,
            "metrics": res["metrics"], "root": root}


@pytest.mark.parametrize("case", PROC_CASES)
def test_processes_match_reference(refs, procs, case):
    _check_against_ref(refs[0], case, procs[case])


def test_dense_arch_matches_reference(refs, procs):
    _check_against_ref(refs[1], "dense", procs["dense"])


def test_train_procs_returns_the_loop_and_hands_off(procs):
    """``train_procs`` returns rank 0's metrics of its own loop (the
    ``mesh`` case) and empties the list that carried the model."""
    assert procs["metrics"] == procs["mesh"][0]
    assert procs["holder"] == []
    assert all(r["mesh"] is None for r in procs["ranks"][1:])


def test_processes_match_the_local_mesh_step(refs, procs, monkeypatch):
    from test_torch_train import _port_run

    metrics, grads, final = procs["mesh"]
    want_m, want_g, want_p = _port_run(refs[0], "mesh", monkeypatch)
    for got, want in zip(metrics, want_m):
        for k in METRICS:
            assert abs(got[k] - want[k]) <= 1e-6 * max(abs(want[k]), 1e-6), k
    for got, want in zip(grads, want_g):
        for k, w in want.items():
            err = float((got[k] - w).norm() / (w.norm() + 1e-12))
            assert err <= 1e-5, (k, err)
    for k, w in want_p.items():
        assert float((final[k] - w).abs().max() / w.abs().max()) <= 1e-6, k


def test_trainer_resume_on_processes(procs):
    """2 steps, the 4 processes' checkpoint, a resume to 4: within 1e-6 of
    4 unbroken steps in every process."""
    for r in procs["ranks"]:
        t = r["trainer"]
        assert t["stopped"] == (4, 4)
        assert t["resume_err"] <= 1e-6


def test_process_checkpoint_restores_without_and_on_a_local_mesh(procs,
                                                                 tmp_path):
    """The step-2 checkpoint the processes wrote holds the whole state: it
    restores bit for bit into a state with no mesh, and a ``LocalMesh``
    Trainer resumed from it lands within 1e-5 of the processes' unbroken
    run (the meshes sum the gradients in different orders)."""
    cfg = _cfg()
    t = procs["trainer"]
    src = os.path.join(procs["root"], "b", "step_000000002")
    ckpt = str(tmp_path / "c")
    os.makedirs(ckpt)
    shutil.copytree(src, os.path.join(ckpt, "step_000000002"))
    from repro_torch.models import build_model

    model = build_model(cfg, "cpu", train=True)

    def init_state():
        return pt_train.init_train_state(model.init(
            torch.Generator().manual_seed(1)))

    state, step = restore_checkpoint(ckpt, init_state())
    assert step == 2 and int(state["step"]) == 2
    got = _state_tensors(state)
    assert set(got) == set(t["b2"])
    for k, v in t["b2"].items():
        assert torch.equal(got[k], v), k
    mesh = make_mesh(SHAPE, AXES, device="cpu")
    step_fn = pt_train.make_train_step(cfg, mesh, pt_train.TrainOptions(
        **TRAINER_OPTIONS), device="cpu")
    res = Trainer(TrainerConfig(total_steps=4, ckpt_dir=ckpt,
                                ckpt_every=100), step_fn, init_state,
                  _data(cfg).batch, mesh=mesh).run()
    assert res["stopped_at"] == 4
    for k, p in res["state"]["params"].named_parameters():
        want = t["a"][k]
        assert float((p.detach() - want).abs().max()
                     / want.abs().max()) <= 1e-5, k


def test_one_process_checkpoint_restores_into_every_shard(procs, reverse):
    """The reverse: a checkpoint written with no mesh, restored by the 4
    processes into their shards, gathers back to the saved state bit for
    bit."""
    want = reverse[1]
    got = procs["trainer"]["reverse"]
    assert set(got) == set(want)
    for k, v in got.items():
        assert torch.equal(v, want[k]), k


def test_preemption_seen_by_one_process_stops_all(procs):
    for r in procs["ranks"]:
        assert r["trainer"]["preempted"] == (True, 2, 2)
    assert sorted(os.listdir(os.path.join(procs["root"], "p"))) == \
        ["metrics.jsonl", "step_000000002"]


def test_procs_cli_trains_as_the_local_mesh(tmp_path):
    """``train --procs`` (4 gloo processes) prints the steps of ``train
    --mesh`` (one process, the ranks stacked): bf16 compute, so within a
    relative 2e-3 (products of other shapes round differently)."""
    args = ["--arch", ARCH, "--smoke", "--device", "cpu", "--mesh", "2,2",
            "--batch", "8", "--seq", "32", "--steps", "3"]
    env = dict(os.environ, PYTHONPATH=SRC)
    proc = subprocess.run(
        [sys.executable, "-m", "repro_torch.launch.train", *args, "--procs",
         "--backend", "gloo", "--init-method",
         f"file://{tmp_path / 'store'}"], capture_output=True, text=True,
        env=env, cwd=REPO, timeout=300)
    assert proc.returncode == 0, proc.stderr[-4000:]
    assert "on 4 processes (gloo, cpu)" in proc.stdout
    local = subprocess.run(
        [sys.executable, "-m", "repro_torch.launch.train", *args],
        capture_output=True, text=True, env=env, cwd=REPO, timeout=300)
    assert local.returncode == 0, local.stderr[-4000:]

    def steps(text):
        return [{k: float(v) for k, v in re.findall(
            r"(loss|nll|grad_norm)=([-\d.e+]+)", line)}
            for line in text.splitlines() if line.startswith("step ")]

    got, want = steps(proc.stdout), steps(local.stdout)
    assert len(got) == len(want) == 3
    for g, w in zip(got, want):
        for k in w:
            assert abs(g[k] - w[k]) <= 2e-3 * abs(w[k]), (k, g[k], w[k])


def test_procs_cli_needs_a_backend():
    with pytest.raises(SystemExit):
        pt_train.main(["--arch", ARCH, "--smoke", "--device", "cpu",
                       "--mesh", "2,2", "--procs"])


def test_pod_compression_is_the_psum_of_equal_copies(monkeypatch):
    """The gradients reach ``_compress_pod_grads`` synced, the same on every
    member of a pod group, so it quantizes, dequantizes and adds the pod's
    copies in place: bit for bit ``ef_compressed_psum`` over the stacked
    copies, divided by the pod's size, with no gather."""
    from repro_torch.comm.collectives import ef_compressed_psum

    mesh = make_mesh(SHAPE, AXES, "cpu")
    dist = pt_train.make_dist_context(smoke_config(ARCH), mesh)
    rng = np.random.default_rng(0)
    grads = {f"g{i}": torch.from_numpy(
        (rng.standard_normal(shape) * 10.0 ** e).astype(np.float32))
        for i, (shape, e) in enumerate([((7,), 0), ((3, 5), -4),
                                        ((2, 3, 4), 3)])}

    def no_gather(*args, **kw):
        raise AssertionError("a replicated gradient was gathered")

    monkeypatch.setattr(pt_train, "all_gather", no_gather)
    got = pt_train._compress_pod_grads(grads, dist)
    pod = mesh.sub(("pod",))
    for k, g in grads.items():
        total, _ = ef_compressed_psum(pod, g.expand(2, *g.shape), "pod")
        assert torch.equal(got[k], total[0] / 2), k
        assert not torch.equal(got[k], g), k   # it did quantize
