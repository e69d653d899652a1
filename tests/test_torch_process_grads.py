"""Gradients through the process mesh's collectives: 4 gloo processes of a
(pod 2, data 2, model 1) ``ProcessMesh`` against the stacked ``LocalMesh``'s
autograd, on the same per-rank inputs and cotangents.

Each process backpropagates its own ``sum(f(x) * ct)``; the processes'
backward collectives carry every cotangent to the rank whose input made it,
so each process's gradient is its row of the stacked gradient of the sum
over ranks.

* ``all_to_all`` (over ``pod``, ``data`` and both, f32 and bf16) and
  ``ppermute`` (a swap, and a partial permutation whose idle ranks get a
  zero gradient): bit for bit.
* ``pmean``: within a relative 1e-6 (its all_reduce sums in the backend's
  order, forward and backward); with its backward replaced by a local
  ``1 / n`` the gradient is off by far more, so the case fails.
* ``all_gather`` (an ``all_to_all`` of copies, whose backward sums them):
  within a relative 1e-6.
* ``member_sum`` adds a tensor's parts, or an iterable's, left to right.
* The MoE island (smoke megatron-moe-32e, f32) through ``flash`` and
  ``direct``: the gradients of every process's rows and of its expert
  slice within a relative norm of 1e-5 of the stacked ones, and the
  router's (a replicated parameter) summed over the processes the same.
"""

import dataclasses

import numpy as np
import pytest
import torch

from repro_torch.configs import smoke_config
from repro_torch.launch import mesh as M
from repro_torch.launch.procs import spawn

SHAPE = (2, 2, 1)
AXES = ("pod", "data", "model")
R = 4
TIMEOUT_S = 60.0
# name -> (collective on (mesh, x), input shape per rank)
CASES = {
    "a2a_pod": (lambda m, x: M.all_to_all(m, x, ("pod",)), (4, 3, 5)),
    "a2a_data": (lambda m, x: M.all_to_all(m, x, ("data",), axis=1),
                 (3, 4, 5)),
    "a2a_pod_data": (lambda m, x: M.all_to_all(m, x, ("pod", "data")),
                     (8, 5)),
    "a2a_bf16": (lambda m, x: M.all_to_all(
        m, x.to(torch.bfloat16), ("pod", "data")).float(), (8, 5)),
    "ppermute_swap": (lambda m, x: M.ppermute(m, x, "pod", [(0, 1), (1, 0)]),
                      (3, 5)),
    "ppermute_partial": (lambda m, x: M.ppermute(m, x, "data", [(0, 1)]),
                         (3, 5)),
    "pmean": (lambda m, x: M.pmean(m, x, ("pod", "data")), (3, 5)),
    "pmean_pod": (lambda m, x: M.pmean(m, x, "pod"), (3, 5)),
    "all_gather": (lambda m, x: M.all_gather(m, x, ("pod", "data")), (3, 5)),
}
EXACT = [k for k in CASES if not k.startswith(("pmean", "all_gather"))]
ROUNDED = [k for k in CASES if k not in EXACT]
IMPLS = ("flash", "direct")


def _inputs():
    rng = np.random.default_rng(7)
    out = {}
    for name, (_, shape) in CASES.items():
        out[name] = rng.normal(size=(R, *shape)).astype(np.float32)
        out[name + "/ct"] = rng.normal(size=(R, *shape)).astype(np.float32)
    # all_gather's output holds n copies: its cotangent is [R, n, ...]
    out["all_gather/ct"] = rng.normal(size=(R, R, 3, 5)).astype(np.float32)
    out["moe/x"] = rng.normal(size=(8, 4, 64)).astype(np.float32)
    out["moe/ct"] = rng.normal(size=(8, 4, 64)).astype(np.float32)
    return out


def _grads(mesh, inp: dict) -> dict:
    """Each case's output and the gradient of ``sum(f(x) * ct)`` over the
    held ranks' rows of ``inp``."""
    out = {}
    for name, (fn, _) in CASES.items():
        x = torch.from_numpy(inp[name]).requires_grad_()
        y = fn(mesh, x)
        (g,) = torch.autograd.grad((y * torch.from_numpy(
            inp[name + "/ct"])).sum(), x)
        out[name], out[name + "/grad"] = y.detach(), g
    return out


def _moe_layer():
    from repro_torch.models.moe import MoE

    cfg = dataclasses.replace(smoke_config("megatron-moe-32e"),
                              compute_dtype="float32")
    layer = MoE(cfg, torch.Generator().manual_seed(0), torch.float32, "cpu",
                masters=True)
    return cfg, layer.requires_grad_()


def _moe_grads(mesh, layer, cfg, x, ct, impl) -> dict:
    """The island's output, aux and gradients of ``sum(y * ct) + 0.01 *
    aux`` per held rank (the stacked form sums that over its ranks), with
    respect to the rows and the layer's parameters."""
    from repro_torch.launch.train import make_dist_context
    from repro_torch.models.moe import moe_apply

    dist = make_dist_context(cfg, mesh, impl)
    x = x.clone().requires_grad_()
    y, aux = moe_apply(cfg, layer, x, dist)
    loss = (y * ct).sum() + 0.01 * aux * mesh.local_size
    params = dict(layer.named_parameters())
    grads = torch.autograd.grad(loss, [x, *params.values()])
    return {"y": y.detach(), "aux": aux.detach(),
            **dict(zip(["x", *params], grads))}


def _rank_work(mesh, inp):
    """One process: every case on its own row, then again with ``pmean``'s
    backward replaced by a local ``1 / n``; the MoE island's gradients on
    its rows and its expert slice."""
    from repro_torch.launch.shardings import shard_tensor

    own = {k: v[mesh.rank:mesh.rank + 1] for k, v in inp.items()
           if not k.startswith("moe/")}
    out = {"sound": _grads(mesh, own)}
    real = M._pmean_backward

    def local_mean(mesh_, g, axes):     # the planted fault
        return g / mesh_.axis_size(axes)

    M._pmean_backward = local_mean
    try:
        out["fault"] = _grads(mesh, own)
    finally:
        M._pmean_backward = real

    from repro_torch.launch.train import train_specs

    cfg, whole = _moe_layer()
    specs = {k.split("moe.", 1)[1]: v for k, v in
             train_specs(cfg, mesh).items() if k.startswith("blocks.0.moe.")}
    layer = _moe_layer()[1]
    with torch.no_grad():
        for name, p in whole.named_parameters():
            cut = shard_tensor(p, specs[name], mesh)
            setattr(layer, name, torch.nn.Parameter(cut.clone()))
    b = inp["moe/x"].shape[0] // R
    rows = slice(mesh.rank * b, (mesh.rank + 1) * b)
    x = torch.from_numpy(inp["moe/x"][rows])
    ct = torch.from_numpy(inp["moe/ct"][rows])
    out["moe"] = {impl: _moe_grads(mesh, layer, cfg, x, ct, impl)
                  for impl in IMPLS}
    return out


@pytest.fixture(scope="module")
def inputs():
    return _inputs()


@pytest.fixture(scope="module")
def local(inputs):
    mesh = M.make_mesh(SHAPE, AXES, device="cpu")
    out = _grads(mesh, {k: v for k, v in inputs.items()
                        if not k.startswith("moe/")})
    cfg, layer = _moe_layer()
    x, ct = (torch.from_numpy(inputs[k]) for k in ("moe/x", "moe/ct"))
    out["moe"] = {impl: _moe_grads(mesh, layer, cfg, x, ct, impl)
                  for impl in IMPLS}
    return out


@pytest.fixture(scope="module")
def procs(tmp_path_factory, inputs):
    rdv = tmp_path_factory.mktemp("rdv") / "store"
    return spawn(_rank_work, SHAPE, AXES, "gloo", "cpu", inputs,
                 init_method=f"file://{rdv}", timeout=TIMEOUT_S,
                 join_timeout=180)


def _stacked(procs, run, key):
    return torch.cat([r[run][key] for r in procs])


def _rel(a, b):
    return float((a - b).abs().max() / b.abs().max())


@pytest.mark.parametrize("name", EXACT)
def test_data_movement_gradients_bit_exact(procs, local, name):
    assert torch.equal(_stacked(procs, "sound", name), local[name])
    got = _stacked(procs, "sound", name + "/grad")
    assert got.abs().max() > 0
    assert torch.equal(got, local[name + "/grad"]), name


@pytest.mark.parametrize("name", ROUNDED)
def test_reducing_gradients_within_rounding(procs, local, name):
    assert _rel(_stacked(procs, "sound", name), local[name]) <= 1e-6
    got = _stacked(procs, "sound", name + "/grad")
    assert _rel(got, local[name + "/grad"]) <= 1e-6, name


def test_ppermute_idle_ranks_get_a_zero_gradient(procs):
    """Data coordinate 1 sends nothing under ``[(0, 1)]``: ranks 1 and 3's
    inputs reach no output, so their gradients are zero."""
    got = _stacked(procs, "sound", "ppermute_partial/grad")
    assert not got[[1, 3]].any() and got[[0, 2]].abs().min() > 0


@pytest.mark.parametrize("name", ["pmean", "pmean_pod"])
def test_pmean_backward_must_average_across_the_group(procs, local, name):
    """With its backward a local ``1 / n`` (the planted fault) the gradient
    leaves every other member's cotangent out: far outside the bound that
    the sound backward keeps."""
    want = local[name + "/grad"]
    assert _rel(_stacked(procs, "fault", name + "/grad"), want) > 1e-2
    assert torch.equal(_stacked(procs, "fault", name),
                       _stacked(procs, "sound", name))


@pytest.mark.parametrize("impl", IMPLS)
def test_moe_island_gradients_match_the_local_mesh(procs, local, impl):
    """Rows and expert slices by rank; the router summed over ranks (each
    process holds a copy, the stacked mesh one tensor)."""
    want = local["moe"][impl]
    ranks = [r["moe"][impl] for r in procs]
    for key in ("y", "x", "w_gate", "w_up", "w_down"):
        got = torch.cat([g[key] for g in ranks])
        err = float((got - want[key]).norm() / want[key].norm())
        assert err <= 1e-5, (impl, key, err)
        assert got.abs().max() > 0, key
    router = sum(g["router"] for g in ranks)
    err = float((router - want["router"]).norm() / want["router"].norm())
    assert err <= 1e-5, (impl, "router", err)
    for g in ranks:
        assert abs(float(g["aux"]) - float(want["aux"])) \
            <= 1e-6 * abs(float(want["aux"]))


@pytest.mark.parametrize("form", ["tensor", "iterable", "moved"])
def test_member_sum_adds_in_member_order(form):
    rng = np.random.default_rng(1)
    parts = torch.from_numpy(
        (rng.standard_normal((5, 64)) * 10.0 ** rng.integers(-6, 6, (5, 1)))
        .astype(np.float32))
    want = parts[0]
    for j in range(1, 5):
        want = want + parts[j]
    arg, dev = {"tensor": (parts, None), "iterable": (iter(parts), None),
                "moved": (list(parts), "cpu")}[form]
    assert torch.equal(M.member_sum(arg, dev), want)
