"""Serving and training through the split-island MoE on one process per rank:
smoke mixtral (4 experts, f32) on gloo CPU processes, each holding its rows
and its shard of the state, ``choose_ep_axes`` picking the form:

* (2, 3, 1), 6 processes: EP over ``pod`` alone (mixtral's production
  layout), the config's ``flash`` exchange (the rotation): exact, with the
  pod axis's int8 gradient compression (``gc``) and with int8 dispatch;
* (3, 2, 1), 6 processes: EP over ``data`` alone;
* (1, 3, 1), 3 processes: no EP, every expert in every process.

Training, 2 AdamW steps of 12 x 16 tokens, against the reference's
``make_train_step`` on 6 fake devices (its run once, in one subprocess), at
``test_torch_train.py``'s tolerances: metrics within a relative 1e-5,
gathered gradients within a relative norm of 1e-4, parameters after the
last step within 1e-5 of each tensor's largest value; int8 dispatch by
the rule of ``_check_int8_against_ref``.  The exact (2, 3, 1) run goes
through ``train_procs``' own loop; ``gc`` keeps ``test_torch_train.py``'s
one-quantum rule.  Every case but ``gc`` is also held against the port's
stacked ``LocalMesh`` step (1e-6, 1e-5, 1e-5), and every expert gradient is
nonzero (a gradient cut by a collective would come back as zeros).
Serving: ``serve_procs`` on (2, 3, 1) against the stacked run, logits
within 1e-5 and greedy tokens equal; and the ``serve --procs`` and ``train
--procs`` command lines on ``--mesh 2,3`` against ``--mesh 2,3`` alone.
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

from repro_torch.configs import smoke_config
from repro_torch.convert import from_jax_params
from repro_torch.data import DataConfig, SyntheticLM
from repro_torch.launch import serve
from repro_torch.launch import train as pt_train
from repro_torch.launch.mesh import make_mesh
from repro_torch.launch.procs import spawn

ARCH = "mixtral-8x7b"
AXES = ("pod", "data", "model")
BATCH, SEQ = 12, 16
# name -> (mesh, config overrides, TrainOptions overrides, EP axes); "mesh"
# and "gc" keep test_torch_train.py's names, which its checks read
CASES = {"mesh": ((2, 3, 1), {}, {}, ("pod",)),
         "gc": ((2, 3, 1), {}, {"grad_compression": True}, ("pod",)),
         "pod_int8": ((2, 3, 1), {"quantized_dispatch": True}, {},
                      ("pod",)),
         "data": ((3, 2, 1), {}, {}, ("data",)),
         "none": ((1, 3, 1), {}, {}, None)}
EXPERT_STACKS = ("w_gate", "w_up", "w_down")

_JAX_SIDE = """
import dataclasses, numpy as np, jax, jax.numpy as jnp
from repro.configs import smoke_config
from repro.data import DataConfig, SyntheticLM
from repro.launch import train as T
from repro.launch.mesh import make_mesh
from repro.models import build_model
from repro.models.dist import choose_ep_axes
from repro.optim import init_opt_state

real_update = T.adamw_update

def spy(grads, opt, params, lr, cfg):
    p, o, n = real_update(grads, opt, params, lr, cfg)
    return p, o, {"norm": n, "grads": grads}

T.adamw_update = spy   # the step reads its gradients out through grad_norm
# The reference's _compress_pod_grads names P, which its module imports
# only inside make_train_step: grad_compression raises NameError without it.
from jax.sharding import PartitionSpec
T.P = PartitionSpec

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

base = dataclasses.replace(smoke_config(ARCH), compute_dtype="float32")
params0 = build_model(base).init(jax.random.PRNGKey(0))
out = {f"init/{k}": v for k, v in flat(params0).items()}
data = SyntheticLM(DataConfig(vocab=base.vocab, seq_len=SEQ,
                              global_batch=BATCH), base)
for name, (shape, over, opt_over, _) in CASES.items():
    cfg = dataclasses.replace(base, **over)
    mesh = make_mesh(shape, ("pod", "data", "model"))
    out[f"{name}/ep"] = np.array(",".join(choose_ep_axes(cfg, mesh) or ()))
    step, _, state_sh, batch_fn = T.make_train_step(
        cfg, mesh, T.TrainOptions(**OPTIONS, **opt_over))
    state = jax.device_put({"params": params0, "opt": init_opt_state(params0),
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


def _cfg(**over):
    return dataclasses.replace(smoke_config(ARCH), compute_dtype="float32",
                               **over)


def _data_cfg(cfg):
    return DataConfig(vocab=cfg.vocab, seq_len=SEQ, global_batch=BATCH)


@pytest.fixture(scope="module")
def ref(tmp_path_factory):
    """Every case's reference run, in one subprocess on 6 fake devices."""
    path = os.path.join(tmp_path_factory.mktemp("pod_ep_train"), "ref.npz")
    out = run_subprocess(
        f"ARCH = {ARCH!r}\nBATCH, SEQ, STEPS = {BATCH}, {SEQ}, {STEPS}\n"
        f"CASES = {CASES!r}\nOPTIONS = {OPTIONS!r}\nOUT = {path!r}\n"
        + _JAX_SIDE, n_devices=6)
    assert "JAX_SIDE_OK" in out
    return dict(np.load(path))


def _module(ref, cfg):
    return from_jax_params(_unflatten(_tree(ref, "init/")), cfg,
                           device="cpu", train=True)


def _gather(mesh, cfg, named):
    """The whole of every tensor of this process's shard ``named``
    (collective); on rank 0 only, else None."""
    from repro_torch.launch.shardings import gather_tensor

    specs = pt_train.train_specs(cfg, mesh)
    whole = {k: gather_tensor(v.detach(), specs[k], mesh)
             for k, v in named.items()}
    return whole if mesh.rank == 0 else None


def _options(case):
    return pt_train.TrainOptions(**OPTIONS, **CASES[case][2])


def _run_case(mesh, case, module, run=None):
    """STEPS steps of ``module`` (this process's shard) on the global
    batches, or ``run()`` (``train_procs``' own loop): the metrics, each
    step's gradients as AdamW got them and the final parameters, gathered
    on rank 0; with each process's expert stack count."""
    cfg = _cfg(**CASES[case][1])
    seen = []
    real = pt_train.adamw_update

    def spy(grads, *args):
        seen.append({k: g.detach().clone() for k, g in grads.items()})
        return real(grads, *args)

    experts = int(module.blocks[0].moe.w_gate.shape[0])
    pt_train.adamw_update = spy
    try:
        if run is None:
            step = pt_train.make_train_step(cfg, mesh, _options(case),
                                            device="cpu")
            state = pt_train.init_train_state(module)
            data, metrics = SyntheticLM(_data_cfg(cfg), cfg), []
            for i in range(STEPS):
                state, m = step(state, data.batch(i))
                metrics.append({k: float(v) for k, v in m.items()})
        else:
            metrics = run()["metrics"]
    finally:
        pt_train.adamw_update = real
    grads = [_gather(mesh, cfg, g) for g in seen]
    final = _gather(mesh, cfg, dict(module.named_parameters()))
    return {"experts": experts, "run": (metrics, grads, final)
            if mesh.rank == 0 else None}


def _train_hook(mesh, cfg, shards, train):
    """(2, 3, 1): the exact case through ``train_procs``' loop, then the
    gradient compression and the int8 dispatch on fresh shards of the same
    initial parameters."""
    from repro_torch.convert import recast

    init = {k: v.detach().clone() for k, v in shards[0].named_parameters()}
    out = {"mesh": _run_case(mesh, "mesh", shards[0], train)}
    for case in ("gc", "pod_int8"):
        c = _cfg(**CASES[case][1])
        out[case] = _run_case(mesh, case, recast(
            {k: v.clone() for k, v in init.items()}, c, train=True))
    return out


def _train_rank(mesh, named, case):
    """Another layout: this process's shard of ``named``, trained."""
    from repro_torch.convert import shard_module

    cfg = _cfg(**CASES[case][1])
    return {case: _run_case(mesh, case, shard_module(named, cfg, mesh,
                                                     train=True))}


@pytest.fixture(scope="module")
def procs(ref, tmp_path_factory):
    """Every case on its processes: rank 0's gathered run and each
    process's expert count."""
    cfg = _cfg()
    res = pt_train.train_procs(
        cfg, [_module(ref, cfg)], _data_cfg(cfg), CASES["mesh"][0], "gloo",
        "cpu", _options("mesh"), STEPS, hook=_train_hook,
        init_method=f"file://{tmp_path_factory.mktemp('rdv') / 'store'}",
        timeout=60.0, join_timeout=240)
    ranks = dict.fromkeys(("mesh", "gc", "pod_int8"), res["ranks"])
    named = {k: v.detach() for k, v in _module(ref, cfg).named_parameters()}
    for case in ("data", "none"):
        rdv = tmp_path_factory.mktemp(f"rdv_{case}") / "store"
        ranks[case] = spawn(_train_rank, CASES[case][0], AXES, "gloo", "cpu",
                            named, case, init_method=f"file://{rdv}",
                            timeout=60.0, join_timeout=240)
    out = {case: {"run": rows[0][case]["run"],
                  "experts": [r[case]["experts"] for r in rows]}
           for case, rows in ranks.items()}
    out["metrics"] = res["metrics"]
    return out


def _check_int8_against_ref(ref, run):
    """int8 dispatch end to end: the metrics within a relative 1e-5, every
    gradient within a relative norm of 1e-3 and every parameter after the
    last step within 1e-4 of its tensor's largest value.  The exchange
    rounds each row to levels of its largest magnitude / 127, so a value
    of the first MoE layer's buffer within the packages' 1e-7 noise of a
    level boundary lands one level apart, and the later layers' gradients
    follow (a relative 1.5e-4 in the router's and 2.8e-5 in a parameter
    after the update seen; the port's own stacked step does the same).
    On identical inputs the int8 layer's gradients agree within 1e-5
    (``test_torch_pod_ep_procs.py``), and the processes hold the stacked
    step at ``test_processes_match_the_local_mesh_step``'s tolerances."""
    metrics, grads, final = run
    for i in range(STEPS):
        for k in METRICS:
            want = float(ref[f"pod_int8/m{i}/{k}"])
            assert abs(metrics[i][k] - want) <= 1e-5 * max(abs(want), 1e-6)
        want = _tree(ref, f"pod_int8/g{i}/")
        assert set(grads[i]) == set(want)
        for k, g in grads[i].items():
            g, w = g.numpy(), want[k]
            assert np.linalg.norm(g - w) / (np.linalg.norm(w) + 1e-12) \
                < 1e-3, (i, k)
    for k, p in final.items():
        w = ref[f"pod_int8/p/{k}"]
        assert np.abs(p.numpy() - w).max() / np.abs(w).max() < 1e-4, k


@pytest.mark.parametrize("case", list(CASES))
def test_processes_train_as_the_reference(ref, procs, case):
    shape, _, _, ep = CASES[case]
    assert str(ref[f"{case}/ep"]) == ",".join(ep or ())
    dist = pt_train.make_dist_context(_cfg(**CASES[case][1]),
                                      make_mesh(shape, AXES, "cpu"))
    assert dist.ep_axes == ep
    p = shape[("pod", "data").index(ep[0])] if ep else 1
    n_exp = _cfg().moe.num_experts
    assert procs[case]["experts"] == [n_exp // p] * int(np.prod(shape))
    if case == "pod_int8":
        _check_int8_against_ref(ref, procs[case]["run"])
    else:
        _check_against_ref(ref, case, procs[case]["run"])


@pytest.mark.parametrize("case", list(CASES))
def test_expert_gradients_nonzero(procs, case):
    """Every expert's gradient of every layer is nonzero in both steps:
    ``materialize_grads`` would hand a gradient cut by a collective back as
    zeros."""
    _, grads, _ = procs[case]["run"]
    n_exp = _cfg().moe.num_experts
    names = [k for k in grads[0] if k.rsplit(".", 1)[-1] in EXPERT_STACKS]
    assert len(names) == 3 * _cfg().n_layers
    for step in grads:
        for k in names:
            g = step[k]
            assert g.shape[0] == n_exp
            assert bool((g.reshape(n_exp, -1).abs().amax(-1) > 0).all()), k


def test_train_procs_returns_its_loop(procs):
    assert procs["metrics"] == procs["mesh"]["run"][0]


@pytest.mark.parametrize("case", [c for c in CASES if c != "gc"])
def test_processes_match_the_local_mesh_step(ref, procs, case):
    """Every case but ``gc`` against the port's stacked step on the same
    mesh (``gc`` rounds to levels, and is held to the reference by its
    one-quantum rule above): the
    metrics within a relative 1e-6, the gradients within a relative norm of
    1e-5 (the 6 processes sum a replicated gradient in member order, the
    stacked step in one reduction), the parameters within 1e-5 of each
    tensor's largest value (Adam's normalised step of an element whose
    gradient lies at that noise follows it)."""
    shape, over, _, _ = CASES[case]
    cfg = _cfg(**over)
    mesh = make_mesh(shape, AXES, "cpu")
    module = _module(ref, cfg)
    seen = []
    real = pt_train.adamw_update

    def spy(grads, *args):
        seen.append({k: g.detach().clone() for k, g in grads.items()})
        return real(grads, *args)

    pt_train.adamw_update = spy
    try:
        step = pt_train.make_train_step(cfg, mesh, _options(case),
                                        device="cpu")
        state = pt_train.init_train_state(module)
        data, want_m = SyntheticLM(_data_cfg(cfg), cfg), []
        for i in range(STEPS):
            state, m = step(state, data.batch(i))
            want_m.append({k: float(v) for k, v in m.items()})
    finally:
        pt_train.adamw_update = real
    metrics, grads, final = procs[case]["run"]
    for got, want in zip(metrics, want_m):
        for k in METRICS:
            assert abs(got[k] - want[k]) <= 1e-6 * max(abs(want[k]), 1e-6), k
    for got, want in zip(grads, seen):
        for k, w in want.items():
            err = float((got[k] - w).norm() / (w.norm() + 1e-12))
            assert err <= 1e-5, (k, err)
    for k, w in module.named_parameters():
        w = w.detach()
        assert float((final[k] - w).abs().max() / w.abs().max()) <= 1e-5, k


# -- serving ------------------------------------------------------------------

SERVE_STEPS = 4


def _serve_rank(mesh, cfg, shards, rows, serve_rows):
    serve_rows()
    return int(shards.pop().blocks[0].moe.w_gate.shape[0])


def test_serve_procs_as_the_local_mesh(ref, tmp_path):
    """``serve_procs`` on (2, 3, 1): each process serves its 2 rows of 12
    on its 2 experts of 4; the prefill and every decode step's logits
    gathered on rank 0 within a relative 1e-5 of the stacked run, greedy
    tokens equal."""
    cfg = _cfg()
    shape = CASES["mesh"][0]
    prompts = torch.from_numpy(np.random.default_rng(3).integers(
        0, cfg.vocab, (BATCH, 8)))
    module = from_jax_params(_unflatten(_tree(ref, "init/")), cfg,
                             device="cpu")
    mesh = make_mesh(shape, AXES, "cpu")
    total = prompts.shape[1] + SERVE_STEPS + 1
    prefill = serve.make_prefill_step(cfg, mesh, cache_len=total,
                                      device="cpu")
    step = serve.make_serve_step(cfg, mesh, device="cpu")
    logits, cache = prefill(module, {"tokens": prompts})
    want, toks = [logits], [logits.argmax(-1)]
    for t in range(prompts.shape[1], total - 1):
        logits, cache = step(module, cache, toks[-1], t)
        want.append(logits)
        toks.append(logits.argmax(-1))
    got = serve.serve_procs(cfg, [module], prompts, shape, "gloo", "cpu",
                            gen_len=SERVE_STEPS + 1, hook=_serve_rank,
                            init_method=f"file://{tmp_path / 'store'}",
                            timeout=60.0, join_timeout=180)
    assert got["ranks"] == [2] * 6
    assert len(got["logits"]) == len(want)
    for g, w in zip(got["logits"], want):
        assert float((g - w).abs().max() / w.abs().max()) < 1e-5
    assert torch.equal(got["tokens"], torch.stack(toks, 1))


def _cli(module, args, procs, tmp_path):
    extra = ["--procs", "--backend", "gloo", "--init-method",
             f"file://{tmp_path / 'store'}"] if procs else []
    proc = subprocess.run(
        [sys.executable, "-m", module, *args, *extra], capture_output=True,
        text=True, env=dict(os.environ, PYTHONPATH=SRC), cwd=REPO,
        timeout=300)
    assert proc.returncode == 0, proc.stderr[-4000:]
    return proc.stdout


def test_serve_cli_on_processes(tmp_path):
    """``serve --procs --mesh 2,3`` (6 gloo processes, EP over ``pod``)
    prints the ``sample:`` line of ``serve --mesh 2,3``."""
    args = ["--arch", ARCH, "--smoke", "--device", "cpu", "--mesh", "2,3",
            "--batch", "6", "--prompt-len", "8", "--gen-len", "4"]
    got = _cli("repro_torch.launch.serve", args, True, tmp_path)
    assert "on 6 processes (gloo, cpu)" in got
    want = _cli("repro_torch.launch.serve", args, False, tmp_path)
    sample = [ln for ln in want.splitlines() if ln.startswith("sample:")]
    assert sample and sample[0] in got.splitlines()


def test_train_cli_on_processes(tmp_path):
    """``train --procs --mesh 2,3`` prints the steps of ``train --mesh
    2,3``: bf16 compute, so within a relative 2e-3."""
    args = ["--arch", ARCH, "--smoke", "--device", "cpu", "--mesh", "2,3",
            "--batch", "12", "--seq", "16", "--steps", "2"]
    got = _cli("repro_torch.launch.train", args, True, tmp_path)
    assert "on 6 processes (gloo, cpu)" in got
    want = _cli("repro_torch.launch.train", args, False, tmp_path)

    def steps(text):
        return [{k: float(v) for k, v in re.findall(
            r"(loss|nll|grad_norm)=([-\d.e+]+)", line)}
            for line in text.splitlines() if line.startswith("step ")]

    got, want = steps(got), steps(want)
    assert len(got) == len(want) == 2
    for g, w in zip(got, want):
        for k in w:
            assert abs(g[k] - w[k]) <= 2e-3 * abs(w[k]), (k, g[k], w[k])
