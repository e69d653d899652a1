"""The split-island MoE (EP over one mesh axis, or none) and its int8
dispatch on one process per rank, against the reference's ``moe_apply`` and
the port's stacked ``LocalMesh`` run.

The layouts and runs of ``test_torch_moe_pod_ep.py``, smoke mixtral in f32
with the experts of each layout, ``choose_ep_axes`` picking the form:

* ``pod``: 4 experts on (2, 3, 1), 6 processes: EP over the slow axis
  alone, through the rotation (``flash``) and the plan's stages, exact and
  int8;
* ``data``: 2 experts on (2, 2, 1), 4 processes: EP over the fast axis
  alone, a flat all-to-all;
* ``none``: 4 experts on (1, 3, 1), 3 processes: no EP, no exchange.

Each process holds its rows of the batch and its shard of the expert stacks
(``E_loc`` of them; all with no EP).  For every run, with and without the
kernel paths:

* the outputs gathered from the processes within a relative 1e-5 of the
  reference's, each process's ``aux`` within 1e-6;
* each process's token grid ``[E_loc, p * C, d]`` bit for bit the
  ``LocalMesh`` grid's slice of its experts and its other DP coordinates,
  and each exchange's output (dispatch and return) bit for bit the
  ``LocalMesh`` exchange's row of its rank.

And under a gradient (the rotation, exact and int8; ``data``; no EP), on
identical inputs: the gradients of ``sum(y * cot) + n * aux`` with respect
to the rows and every parameter, each process's summed over the processes
that hold copies of it, within a relative 1e-5 of ``jax.grad`` of the
reference's.  Under int8 the rounded levels carry no gradient and the
scales do, as the reference's ``round`` has a zero derivative.

The reference runs once, in one subprocess (``test_torch_moe_pod_ep.py``'s
program); each layout's processes are started once with the ``spawn``
method and join through a ``file://`` rendezvous under the test's temporary
directory.
"""

import dataclasses
import os

import numpy as np
import pytest
import torch
from conftest import run_subprocess
from test_torch_moe_pod_ep import _JAX_SIDE, CASES, RUNS, _dist, _rel, _setup

from repro_torch.launch.procs import spawn
from repro_torch.launch.shardings import shard_tensor
from repro_torch.models import moe

AXES = ("pod", "data", "model")
USE_KERNEL = (True, False)
KEYS = [(case, impl, quant, uk) for case, impl, quant in RUNS
        for uk in USE_KERNEL]
# the runs differentiated (the plan's pack has no gradient in either
# package)
GRAD_RUNS = [("pod", "flash", False), ("pod", "flash", True),
             ("data", "flash", False), ("none", "flash", False)]
GRAD_KEYS = [(case, impl, quant, uk) for case, impl, quant in GRAD_RUNS
             for uk in USE_KERNEL]
GRAD_IDS = [f"{c}-{i}-{int(q)}-{'kernel' if uk else 'plain'}"
            for c, i, q, uk in GRAD_KEYS]
PARAMS = ("router", "w_gate", "w_up", "w_down")

_GRAD_SIDE = """
grads = {}
for case, impl, quant in GRAD_RUNS:
    n_exp, shape, batch, _ = CASES[case]
    cfg = dataclasses.replace(smoke_config("mixtral-8x7b"),
                              compute_dtype="float32",
                              moe=MoESpec(num_experts=n_exp, top_k=2),
                              quantized_dispatch=quant)
    p = init_moe(jax.random.PRNGKey(0), cfg)
    x = (np.random.default_rng(1).normal(size=(batch, 8, cfg.d_model))
         * 0.3).astype(np.float32)
    cot = np.random.default_rng(2).normal(size=x.shape).astype(np.float32)
    mesh = make_mesh(shape, ("pod", "data", "model"))
    n = shape[0] * shape[1]
    dist = DistContext(mesh=mesh, dp_axes=("pod", "data"), slow_axis="pod",
                       ep_axes=choose_ep_axes(cfg, mesh), a2a_impl=impl)
    xg = jax.device_put(jnp.asarray(x),
                        NamedSharding(mesh, P(("pod", "data"))))

    def loss(pp, xx):
        y, aux = moe_apply(cfg, pp, xx, dist)
        return jnp.sum(y * cot) + n * aux

    gp, gx = jax.jit(jax.grad(loss, argnums=(0, 1)))(p, xg)
    key = f"{case}_{impl}_{int(quant)}"
    grads.update({f"{key}_g_{k}": np.asarray(v) for k, v in gp.items()})
    grads[f"{key}_gx"] = np.asarray(gx)
    grads[f"{key}_cot"] = cot
np.savez(OUT_GRAD, **grads)
print("GRAD_SIDE_OK")
"""
IDS = [f"{c}-{i}-{int(q)}-{'kernel' if uk else 'plain'}"
       for c, i, q, uk in KEYS]


class _Spy:
    """While active, records every grid ``_expert_ffn`` runs on and every
    output of the split island's exchanges (the dispatch, then the return
    trip)."""

    def __init__(self):
        self.grids, self.exchanged = [], []

    def __enter__(self):
        self.ffn, self.exchange = moe._expert_ffn, moe._pod_ep_exchange

        def ffn(cfg, w_gate, w_up, w_down, tokens, *args, **kw):
            self.grids.append(tokens.detach().clone())
            return self.ffn(cfg, w_gate, w_up, w_down, tokens, *args, **kw)

        def exchange(*args):
            fn = self.exchange(*args)

            def run(buf):
                out = fn(buf)
                self.exchanged.append(out.detach().clone())
                return out
            return run

        moe._expert_ffn, moe._pod_ep_exchange = ffn, exchange
        return self

    def __exit__(self, *exc):
        moe._expert_ffn, moe._pod_ep_exchange = self.ffn, self.exchange


def _run(cfg, layer, x, dist):
    with _Spy() as spy, torch.no_grad():
        y, aux = moe.moe_apply(cfg, layer, x, dist)
    return {"y": y.numpy(), "aux": float(aux),
            "grid": spy.grids[0].numpy(),
            "exchanged": [e.numpy() for e in spy.exchanged]}


def _rank_work(mesh, jax_side, case):
    """One process: its rows and its shard of the experts, through every
    run of ``case`` with and without the kernel paths."""
    out = {"rank": mesh.rank, "coords": mesh.rank_coords}
    for c, impl, quant, uk in KEYS:
        if c != case:
            continue
        cfg, layer, _, x = _setup(jax_side, case, quant)
        dist = _dist(cfg, mesh, impl, uk)
        ep = dist.ep_axes[0] if dist.ep_axes else None
        for name in ("w_gate", "w_up", "w_down"):
            w = getattr(layer, name)
            setattr(layer, name, torch.nn.Parameter(
                shard_tensor(w.detach(), (ep, None, None), mesh).clone()))
        rows = shard_tensor(x, (("pod", "data"), None, None), mesh)
        res = _run(cfg, layer, rows, dist)
        res["experts"] = int(layer.w_gate.shape[0])
        out[(impl, quant, uk)] = res
    for c, impl, quant, uk in GRAD_KEYS:
        if c == case:
            out[("grad", impl, quant, uk)] = _grads(mesh, jax_side, case,
                                                   impl, quant, uk)
    return out


def _grads(mesh, jax_side, case, impl, quant, uk):
    """This process's gradients of ``sum(y * cot) + aux`` (its rows' part
    of the reference's loss; the processes' sum is the whole) with respect
    to its rows and its shard of the parameters."""
    cfg, layer, _, x = _setup(jax_side, case, quant)
    dist = _dist(cfg, mesh, impl, uk)
    ep = dist.ep_axes[0] if dist.ep_axes else None
    for name in ("w_gate", "w_up", "w_down"):
        setattr(layer, name, torch.nn.Parameter(shard_tensor(
            getattr(layer, name).detach(), (ep, None, None), mesh).clone()))
    spec = (("pod", "data"), None, None)
    rows = shard_tensor(x, spec, mesh).clone().requires_grad_(True)
    cot = shard_tensor(torch.from_numpy(
        jax_side[f"{case}_{impl}_{int(quant)}_cot"]), spec, mesh)
    params = [getattr(layer, k).requires_grad_(True) for k in PARAMS]
    y, aux = moe.moe_apply(cfg, layer, rows, dist)
    got = torch.autograd.grad((y * cot).sum() + aux, [rows] + params)
    return {k: g.numpy() for k, g in zip(("x",) + PARAMS, got)}


@pytest.fixture(scope="module")
def jax_side(tmp_path_factory):
    """The reference's moe_apply on fake devices, and its gradients, in one
    subprocess."""
    d = tmp_path_factory.mktemp("pod_ep_procs")
    path, grad = os.path.join(d, "ref.npz"), os.path.join(d, "grad.npz")
    out = run_subprocess(f"CASES = {CASES!r}\nRUNS = {RUNS!r}\n"
                         f"GRAD_RUNS = {GRAD_RUNS!r}\nOUT = {path!r}\n"
                         f"OUT_GRAD = {grad!r}\n" + _JAX_SIDE + _GRAD_SIDE)
    assert "JAX_SIDE_OK" in out and "GRAD_SIDE_OK" in out
    return {**np.load(path), **np.load(grad)}


@pytest.fixture(scope="module")
def procs(jax_side, tmp_path_factory):
    """Each layout's processes, started once: their results by rank."""
    out = {}
    for case, (_, shape, _, _) in CASES.items():
        rdv = tmp_path_factory.mktemp(f"rdv_{case}") / "store"
        out[case] = spawn(_rank_work, shape, AXES, "gloo", "cpu", jax_side,
                          case, init_method=f"file://{rdv}", timeout=60.0,
                          join_timeout=180)
    return out


@pytest.fixture(scope="module")
def local(jax_side):
    """The stacked LocalMesh run of every key."""
    out = {}
    for case, impl, quant, uk in KEYS:
        cfg, layer, mesh, x = _setup(jax_side, case, quant)
        out[(case, impl, quant, uk)] = _run(cfg, layer, x,
                                            _dist(cfg, mesh, impl, uk))
    return out


def _grid_slice(grid, case, coords):
    """The LocalMesh grid ``[E, R * C, d]``'s rows of the process at
    ``coords`` (pod, data): its EP coordinate's experts and the block of
    its other DP coordinates, ``[E_loc, p * C, d]``."""
    n_exp, shape, _, ep = CASES[case]
    sizes = dict(zip(("pod", "data"), shape[:2]))
    where = dict(zip(("pod", "data"), coords[:2]))
    others = [a for a in ("pod", "data") if a not in (ep or ())]
    if ep:
        e_loc = n_exp // sizes[ep[0]]
        c = where[ep[0]]
        experts = slice(c * e_loc, (c + 1) * e_loc)
    else:
        experts = slice(None)
    g = grid.reshape(n_exp, *[sizes[a] for a in others], -1, grid.shape[-1])
    return g[(experts, *[where[a] for a in others])]


@pytest.mark.parametrize("key", KEYS, ids=IDS)
def test_processes_match_reference(jax_side, procs, key):
    case, impl, quant, uk = key
    ranks = procs[case]
    y = np.concatenate([r[(impl, quant, uk)]["y"] for r in ranks])
    want = jax_side[f"{case}_{impl}_{int(quant)}_y"]
    assert y.shape == want.shape
    assert _rel(y, want) < 1e-5
    aux = float(jax_side[f"{case}_{impl}_{int(quant)}_aux"])
    for r in ranks:
        assert abs(r[(impl, quant, uk)]["aux"] - aux) < 1e-6, r["rank"]


@pytest.mark.parametrize("key", KEYS, ids=IDS)
def test_grid_and_exchanges_bit_identical_to_local_mesh(procs, local, key):
    case, impl, quant, uk = key
    n_exp, shape, _, ep = CASES[case]
    want = local[key]
    p = shape[("pod", "data").index(ep[0])] if ep else 1
    for r in procs[case]:
        got = r[(impl, quant, uk)]
        assert got["experts"] == n_exp // p
        grid = _grid_slice(want["grid"], case, r["coords"])
        assert got["grid"].shape == grid.shape
        assert np.array_equal(got["grid"], grid), r["rank"]
        assert len(got["exchanged"]) == len(want["exchanged"]) == \
            (2 if ep else 0)
        for mine, stacked in zip(got["exchanged"], want["exchanged"]):
            assert np.array_equal(mine, stacked[r["rank"]:r["rank"] + 1]), \
                r["rank"]


@pytest.mark.parametrize("key", GRAD_KEYS, ids=GRAD_IDS)
def test_gradients_match_reference(jax_side, procs, key):
    """The rows' gradients gathered; the router's summed over every
    process; an expert stack's, for each EP coordinate, summed over the
    processes that hold that coordinate's experts (with no EP, over all).
    Every expert's gradient is nonzero."""
    case, impl, quant, uk = key
    n_exp, _, _, ep = CASES[case]
    ranks = [r[("grad", impl, quant, uk)] for r in procs[case]]
    ref = f"{case}_{impl}_{int(quant)}"
    gx = np.concatenate([g["x"] for g in ranks])
    assert _rel(gx, jax_side[f"{ref}_gx"]) < 1e-5
    assert _rel(sum(g["router"] for g in ranks),
                jax_side[f"{ref}_g_router"]) < 1e-5
    axis = ("pod", "data").index(ep[0]) if ep else None
    for name in PARAMS[1:]:
        blocks = {}
        for r, g in zip(procs[case], ranks):
            c = r["coords"][axis] if ep else 0
            blocks[c] = blocks.get(c, 0) + g[name]
        got = np.concatenate([blocks[c] for c in sorted(blocks)])
        want = jax_side[f"{ref}_g_{name}"]
        assert got.shape == want.shape == (n_exp, *want.shape[1:])
        assert _rel(got, want) < 1e-5, name
        assert (np.abs(got).reshape(n_exp, -1).max(-1) > 0).all(), name


def test_the_grid_holds_every_rows_tokens(procs, local):
    """The processes' grids, put back together, are the LocalMesh grid: no
    expert's rows are missing or held twice."""
    for case, (n_exp, shape, _, ep) in CASES.items():
        key = next(k for k in KEYS if k[0] == case)
        want = local[key]["grid"]
        seen = np.zeros(want.shape[:2], bool)
        for r in procs[case]:
            grid = r[key[1:]]["grid"]
            hit = np.zeros(want.shape[:2], bool)
            idx = np.arange(want.shape[0] * want.shape[1]).reshape(
                want.shape[:2])
            for i in _grid_slice(idx[..., None], case, r["coords"])\
                    .reshape(-1):
                hit.flat[i] = True
            assert not (seen & hit).any(), (case, r["rank"])
            seen |= hit
            assert grid.shape[0] * grid.shape[1] == hit.sum()
        assert seen.all(), case


def test_int8_dispatch_on_processes_is_close_to_exact(procs):
    """int8 over the slow axis on the processes: within (0, 0.05) of the
    exact run, the same through the rotation and the plan."""
    ranks = procs["pod"]
    exact = np.concatenate([r[("flash", False, True)]["y"] for r in ranks])
    quant = [np.concatenate([r[(impl, True, True)]["y"] for r in ranks])
             for impl in ("flash", "plan")]
    assert 0 < _rel(quant[0], exact) < 0.05
    assert np.array_equal(quant[0], quant[1])


def test_a_whole_expert_stack_is_refused_under_ep():
    """A process handed every expert where its shard holds ``E_loc`` (the
    grid and the stacks would disagree) is told so, not run."""
    from repro_torch.configs import smoke_config
    from repro_torch.configs.registry import MoESpec
    from repro_torch.launch.mesh import ProcessMesh
    from repro_torch.launch.serve import make_dist_context

    shape = CASES["pod"][1]
    cfg = dataclasses.replace(smoke_config("mixtral-8x7b"),
                              compute_dtype="float32",
                              moe=MoESpec(num_experts=4, top_k=2))
    mesh = ProcessMesh(shape=shape, axis_names=AXES,
                       device=torch.device("cpu"), rank=0, backend="gloo",
                       root_shape=shape, root_axes=AXES,
                       root_coords=(0, 0, 0), groups={})
    layer = moe.MoE(cfg, torch.Generator().manual_seed(0), torch.float32,
                    "cpu")
    dist = make_dist_context(cfg, mesh, "flash")
    assert dist.ep_axes == ("pod",)
    calls = []
    real = moe._pod_ep_exchange
    moe._pod_ep_exchange = lambda *a: (lambda buf: calls.append(1) or buf)
    try:
        with pytest.raises(ValueError, match="E_loc = 2"):
            moe.moe_apply(cfg, layer, torch.zeros(1, 8, cfg.d_model), dist)
    finally:
        moe._pod_ep_exchange = real
    assert calls == [1]
