"""The serving slice on one process per rank: smoke megatron-moe-32e (f32)
served through ``launch/serve.py`` on 4 gloo processes of a (pod 2, data 2,
model 1) mesh, each holding its batch rows and its shard of the parameters.

* The prefill and 4 greedy decode steps, gathered on rank 0, within a
  relative 1e-4 of the reference's run on 4 fake devices (the same plan,
  the same parameters and prompts) and within 1e-5 of the port's stacked
  ``LocalMesh`` run, with equal greedy tokens.
* ``shard_params`` (the reference's parameters cut for one process) and
  ``shard_module`` (a port module's) give every process the same shard:
  its experts ``[E_loc, ...]`` and the replicated rest.
* ``serve_procs`` takes the model from the list it is given (the parent's
  hand-off) and runs the per-rank hook on each process's own shard and rows.
* The ``--procs`` command line serves the same tokens as ``--mesh`` on one
  process.
"""

import contextlib
import dataclasses
import io
import os
import subprocess
import sys

import numpy as np
import pytest
import torch
from conftest import REPO, SRC, run_subprocess

from repro_torch.configs import smoke_config
from repro_torch.convert import from_jax_params, shard_module, shard_params
from repro_torch.launch import serve
from repro_torch.launch.mesh import make_mesh
from repro_torch.launch.shardings import module_specs

ARCH = "megatron-moe-32e"
SHAPE = (2, 2, 1)
AXES = ("pod", "data", "model")
B, S, STEPS = 8, 16, 4

_JAX_SIDE = """
import dataclasses
import numpy as np, jax, jax.numpy as jnp
from repro.configs import smoke_config
from repro.core.schedulers import get_scheduler
from repro.core.traffic import ClusterSpec, moe_workload
from repro.launch.mesh import make_mesh
from repro.launch.serve import make_serve_step
from repro.launch.train import make_dist_context, make_rules
from repro.models import use_mesh_rules
from repro.models.transformer import init_lm, lm_prefill

cfg = dataclasses.replace(smoke_config(ARCH), compute_dtype="float32")
params = init_lm(jax.random.PRNGKey(1), cfg)
flat = {"/".join(str(getattr(p, "key", getattr(p, "idx", p)))
                 for p in path): np.asarray(v)
        for path, v in jax.tree_util.tree_flatten_with_path(params)[0]}
prompts = np.random.default_rng(3).integers(0, cfg.vocab, (B, S))
mesh = make_mesh((2, 2, 1), ("pod", "data", "model"))
plan = get_scheduler("flash").synthesize(
    moe_workload(ClusterSpec(2, 2), tokens_per_gpu=2048, bytes_per_token=2,
                 seed=0))
dist = make_dist_context(cfg, mesh, "plan", plan=plan)
with use_mesh_rules(make_rules(cfg, mesh)):
    logits, cache = jax.jit(lambda p, t: lm_prefill(
        cfg, p, t, None, dist, cache_len=S + STEPS))(params,
                                                     jnp.asarray(prompts))
step = make_serve_step(cfg, mesh, "plan", plan)
out = {"logits0": np.asarray(logits)}
toks = jnp.argmax(logits, -1)
for i, t in enumerate(range(S, S + STEPS)):
    logits, cache = step(params, cache, toks, jnp.int32(t))
    out[f"logits{i + 1}"] = np.asarray(logits)
    toks = jnp.argmax(logits, -1)
np.savez(OUT, prompts=prompts, **out, **{"p/" + k: v for k, v in flat.items()})
print("JAX_SIDE_OK")
"""


def _unflatten(flat):
    """``{"a/0/b": array}`` -> nested dicts, digit keys as list indices."""
    root = {}
    for key, v in flat.items():
        node = root
        parts = key.split("/")
        for p in parts[:-1]:
            node = node.setdefault(p, {})
        node[parts[-1]] = v

    def fix(node):
        if not isinstance(node, dict):
            return node
        node = {k: fix(v) for k, v in node.items()}
        if all(k.isdigit() for k in node):
            return [node[str(i)] for i in range(len(node))]
        return node

    return fix(root)


def _rel(a, b):
    a, b = np.asarray(a), np.asarray(b)
    return float(np.abs(a - b).max() / (np.abs(b).max() + 1e-9))


@pytest.fixture(scope="module")
def ref(tmp_path_factory):
    path = str(tmp_path_factory.mktemp("serve_procs") / "ref.npz")
    code = (f"ARCH = {ARCH!r}\nB, S, STEPS = {B}, {S}, {STEPS}\n"
            f"OUT = {path!r}\n" + _JAX_SIDE)
    assert "JAX_SIDE_OK" in run_subprocess(code, n_devices=4)
    data = dict(np.load(path))
    params = _unflatten({k[2:]: v for k, v in data.items()
                         if k.startswith("p/")})
    return {"params": params, "prompts": data["prompts"],
            "logits": [data[f"logits{i}"] for i in range(STEPS + 1)]}


@pytest.fixture(scope="module")
def cfg():
    return dataclasses.replace(smoke_config(ARCH), compute_dtype="float32")


@pytest.fixture(scope="module")
def plan():
    return serve.flash_plan(2, 2, seed=0)


@pytest.fixture(scope="module")
def module(ref, cfg):
    return from_jax_params(ref["params"], cfg, device="cpu")


@pytest.fixture(scope="module")
def local_run(ref, cfg, plan, module):
    """The stacked LocalMesh run: prefill and STEPS greedy decode steps."""
    mesh = make_mesh(SHAPE, AXES, device="cpu")
    prefill = serve.make_prefill_step(cfg, mesh, "plan", plan,
                                      cache_len=S + STEPS, device="cpu")
    step = serve.make_serve_step(cfg, mesh, "plan", plan, device="cpu")
    logits, cache = prefill(module, {"tokens": torch.from_numpy(
        ref["prompts"])})
    out, toks = [logits], [logits.argmax(-1)]
    for t in range(S, S + STEPS):
        logits, cache = step(module, cache, toks[-1], t)
        out.append(logits)
        toks.append(logits.argmax(-1))
    return {"logits": out, "tokens": torch.stack(toks, 1)}


def _rank_hook(mesh, cfg, shards, rows, serve_rows):
    """Serve, then report what this process held."""
    serve_rows()
    w = shards.pop().blocks[0].moe.w_gate
    return {"rank": mesh.rank, "experts": int(w.shape[0]),
            "rows": int(rows.shape[0])}


@pytest.fixture(scope="module")
def procs_run(ref, cfg, plan, module, tmp_path_factory):
    rdv = tmp_path_factory.mktemp("rdv") / "store"
    holder = [module]
    out = serve.serve_procs(cfg, holder, torch.from_numpy(ref["prompts"]),
                            SHAPE, "gloo", "cpu", "plan", plan,
                            gen_len=STEPS + 1, hook=_rank_hook,
                            init_method=f"file://{rdv}", timeout=30.0,
                            join_timeout=180)
    return {**out, "holder": holder}


@pytest.mark.parametrize("step", range(STEPS + 1))
def test_processes_match_reference_and_local_mesh(ref, local_run, procs_run,
                                                  step):
    got = procs_run["logits"][step].numpy()
    assert got.shape == (B, smoke_config(ARCH).vocab)
    assert _rel(got, ref["logits"][step]) < 1e-4, step
    assert _rel(got, local_run["logits"][step].numpy()) < 1e-5, step


def test_greedy_tokens_equal(ref, local_run, procs_run):
    assert torch.equal(procs_run["tokens"], local_run["tokens"])
    want = np.stack([lg.argmax(-1) for lg in ref["logits"]], 1)
    assert np.array_equal(procs_run["tokens"].numpy(), want)


def test_serve_procs_hands_off_the_model(procs_run):
    """The list that carried the model comes back empty, and each process
    served on its one expert of the 4 and its B / 4 rows."""
    assert procs_run["holder"] == []
    assert procs_run["ranks"] == [{"rank": r, "experts": 1, "rows": B // 4}
                                  for r in range(4)]


@pytest.mark.parametrize("rank", range(4))
def test_shard_params_equals_shard_module(ref, cfg, module, rank):
    """The reference's parameters cut for a rank (``shard_params``) load to
    the same tensors as the port module's cut (``shard_module``): the
    rank's one expert of the 4 and the replicated rest."""
    from repro_torch.launch.mesh import ProcessMesh

    coords = tuple(int(c) for c in np.unravel_index(rank, SHAPE))
    mesh = ProcessMesh(shape=SHAPE, axis_names=AXES,
                       device=torch.device("cpu"), rank=rank,
                       backend="gloo", root_shape=SHAPE, root_axes=AXES,
                       root_coords=coords, groups={})
    _, specs, _, _ = serve.serve_state_shapes(cfg, mesh, B, S)
    cut = from_jax_params(shard_params(ref["params"], specs, mesh, coords),
                          cfg, device="cpu", shard=True)
    own = shard_module(module, cfg, mesh)
    got = dict(cut.named_parameters())
    for name, p in own.named_parameters():
        assert torch.equal(got[name], p), name
    w = own.blocks[0].moe.w_gate
    assert w.shape[0] == 1
    assert torch.equal(w, module.blocks[0].moe.w_gate[rank:rank + 1])
    specs = module_specs(cfg, mesh, module)
    assert specs["blocks.0.moe.w_gate"][0] == ("pod", "data")


def test_procs_cli_serves_the_local_mesh_tokens(tmp_path):
    args = ["--arch", ARCH, "--smoke", "--device", "cpu", "--mesh", "2,2",
            "--batch", "4", "--prompt-len", "8", "--gen-len", "4"]
    env = dict(os.environ, PYTHONPATH=SRC)
    proc = subprocess.run(
        [sys.executable, "-m", "repro_torch.launch.serve", *args, "--procs",
         "--backend", "gloo", "--init-method",
         f"file://{tmp_path / 'store'}"], capture_output=True, text=True,
        env=env, cwd=REPO, timeout=300)
    assert proc.returncode == 0, proc.stderr[-4000:]
    assert "on 4 processes (gloo, cpu)" in proc.stdout
    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        serve.main(args)
    sample = [ln for ln in buf.getvalue().splitlines()
              if ln.startswith("sample:")]
    assert sample and sample[0] in proc.stdout.splitlines()


def test_procs_cli_needs_a_backend():
    with pytest.raises(SystemExit):
        serve.main(["--arch", ARCH, "--smoke", "--device", "cpu", "--mesh",
                    "2,2", "--procs"])
