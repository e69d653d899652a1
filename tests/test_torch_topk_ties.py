"""The router's top-k on tied probabilities, against the reference's
``lax.top_k``: the lower expert first among equal values.

Smoke mixtral (f32) with E in {8, 16, 32} experts and top-k in {2, 4}, on
rows with exact ties:

* ``zero``: a zero router, so every expert has the probability 1 / E;
* ``two_level``: the router the identity on the first E features and rows
  of zeros and ones there, so each row's probabilities take two values.

The reference's ``_route`` and ``moe_apply`` run in one subprocess: its
one-rank path, and its island on a (2, 2, 1) mesh of 4 fake devices.  The
port's ``_route`` gives the reference's expert ids bit for bit and its
gates within 1e-6; ``moe_apply`` on one rank, and on 4 gloo processes of a
(2, 2, 1) ``ProcessMesh`` (each with its rows and its E / 4 experts, the
ids it routes read by a spy on ``_route``), gives the outputs within a
relative 1e-5 and ``aux`` within 1e-6 (``test_torch_moe.py``'s
tolerances).  ``torch.topk`` picks another set of experts on these rows.
"""

import dataclasses
import os

import numpy as np
import pytest
import torch
from conftest import run_subprocess

from repro_torch.configs import smoke_config
from repro_torch.configs.registry import MoESpec
from repro_torch.convert import load_params
from repro_torch.launch.procs import spawn
from repro_torch.launch.serve import make_dist_context
from repro_torch.models import moe

SHAPE = (2, 2, 1)
AXES = ("pod", "data", "model")
B, S = 8, 8
CASES = [(e, k, rows) for e in (8, 16, 32) for k in (2, 4)
         for rows in ("zero", "two_level")]

_JAX_SIDE = """
import dataclasses, numpy as np, jax, jax.numpy as jnp
from jax.sharding import NamedSharding, PartitionSpec as P
from repro.configs import smoke_config
from repro.configs.registry import MoESpec
from repro.launch.mesh import make_mesh
from repro.models.dist import DistContext
from repro.models.moe import _route, init_moe, moe_apply

out = {}
mesh = make_mesh(SHAPE, ("pod", "data", "model"))
for e, k, rows in CASES:
    key = f"{e}_{k}_{rows}"
    cfg = dataclasses.replace(smoke_config("mixtral-8x7b"),
                              compute_dtype="float32",
                              moe=MoESpec(num_experts=e, top_k=k))
    p = {n: np.asarray(v) for n, v in
         init_moe(jax.random.PRNGKey(0), cfg).items()}
    rng = np.random.default_rng(e * 10 + k)
    x = (rng.normal(size=(B, S, cfg.d_model)) * 0.3).astype(np.float32)
    if rows == "zero":
        p["router"] = np.zeros_like(p["router"])
    else:
        p["router"] = np.eye(cfg.d_model, e, dtype=np.float32)
        x[..., :e] = rng.integers(0, 2, size=(B, S, e))
    out.update({f"{key}/p_{n}": v for n, v in p.items()})
    out[f"{key}/x"] = x
    gates, eids, aux = _route(cfg, jnp.asarray(p["router"]),
                              jnp.asarray(x.reshape(B * S, -1)))
    out[f"{key}/gates"], out[f"{key}/eids"] = np.asarray(gates), \\
        np.asarray(eids)
    y, aux = moe_apply(cfg, p, jnp.asarray(x), None)
    out[f"{key}/y"], out[f"{key}/aux"] = np.asarray(y), np.asarray(aux)
    dist = DistContext(mesh=mesh, dp_axes=("pod", "data"), slow_axis="pod",
                       ep_axes=("pod", "data"), a2a_impl="direct")
    xg = jax.device_put(jnp.asarray(x),
                        NamedSharding(mesh, P(("pod", "data"))))
    y, aux = jax.jit(lambda pp, xx: moe_apply(cfg, pp, xx, dist))(p, xg)
    out[f"{key}/y_mesh"], out[f"{key}/aux_mesh"] = np.asarray(y), \\
        np.asarray(aux)
np.savez(OUT, **out)
print("JAX_SIDE_OK")
"""


@pytest.fixture(scope="module")
def ref(tmp_path_factory):
    path = os.path.join(tmp_path_factory.mktemp("ties"), "ref.npz")
    out = run_subprocess(f"CASES = {CASES!r}\nB, S = {B}, {S}\n"
                         f"SHAPE = {SHAPE!r}\nOUT = {path!r}\n" + _JAX_SIDE,
                         n_devices=4)
    assert "JAX_SIDE_OK" in out
    return dict(np.load(path))


def _key(case):
    return "{}_{}_{}".format(*case)


def _cfg(e, k):
    return dataclasses.replace(smoke_config("mixtral-8x7b"),
                               compute_dtype="float32",
                               moe=MoESpec(num_experts=e, top_k=k))


def _layer(cfg, params):
    layer = moe.MoE(cfg, torch.Generator().manual_seed(0), torch.float32,
                    "cpu")
    return load_params(layer, params)


def _params(ref, key):
    pre = f"{key}/p_"
    return {n[len(pre):]: v for n, v in ref.items() if n.startswith(pre)}


def _rel(y, want):
    return float(np.abs(y - want).max() / (np.abs(want).max() + 1e-9))


@pytest.mark.parametrize("case", CASES, ids=_key)
def test_route_breaks_ties_as_lax_top_k(ref, case):
    e, k, _ = case
    key, cfg = _key(case), _cfg(e, k)
    x = torch.from_numpy(ref[f"{key}/x"]).reshape(1, B * S, -1)
    router = torch.from_numpy(ref[f"{key}/p_router"])
    gates, eids, _ = moe._route(cfg, router, x)
    assert np.array_equal(eids[0].numpy(), ref[f"{key}/eids"])
    assert np.abs(gates[0].numpy() - ref[f"{key}/gates"]).max() < 1e-6
    # the fault this repairs: torch.topk picks another set on these rows
    probs = torch.softmax(x.float() @ router, dim=-1)
    picked = torch.topk(probs, k, dim=-1).indices[0].sort(-1).values
    assert not np.array_equal(picked.numpy(),
                              np.sort(ref[f"{key}/eids"], -1))


@pytest.mark.parametrize("case", CASES, ids=_key)
def test_moe_apply_on_ties_matches_reference(ref, case):
    e, k, _ = case
    key, cfg = _key(case), _cfg(e, k)
    layer = _layer(cfg, _params(ref, key))
    with torch.no_grad():
        y, aux = moe.moe_apply(cfg, layer, torch.from_numpy(ref[f"{key}/x"]))
    assert _rel(y.numpy(), ref[f"{key}/y"]) < 1e-5
    assert abs(float(aux) - float(ref[f"{key}/aux"])) < 1e-6


def _rank_cases(mesh, cases):
    """Every case on this process: its rows, its E / 4 experts."""
    r, n = mesh.rank, mesh.size
    out = {}
    for key, (e, k), params, x in cases:
        cfg = _cfg(e, k)
        e_loc = e // n
        own = {name: v[r * e_loc:(r + 1) * e_loc] if name != "router" else v
               for name, v in params.items()}
        layer = moe.MoE(cfg, torch.Generator(), torch.float32, "cpu")
        for name, v in own.items():
            setattr(layer, name, torch.nn.Parameter(
                torch.from_numpy(np.ascontiguousarray(v)),
                requires_grad=False))
        rows = torch.from_numpy(x[r * (B // n):(r + 1) * (B // n)])
        seen = []
        real = moe._route

        def spy(*args):
            got = real(*args)
            seen.append(got[1].clone())
            return got

        moe._route = spy
        try:
            with torch.no_grad():
                y, aux = moe.moe_apply(cfg, layer, rows,
                                       make_dist_context(cfg, mesh, "direct"))
        finally:
            moe._route = real
        out[key] = (y.numpy(), float(aux), seen[0][0].numpy())
    return out


@pytest.fixture(scope="module")
def procs(ref, tmp_path_factory):
    cases = [(_key(c), c[:2], _params(ref, _key(c)), ref[f"{_key(c)}/x"])
             for c in CASES]
    rdv = tmp_path_factory.mktemp("rdv") / "store"
    return spawn(_rank_cases, SHAPE, AXES, "gloo", "cpu", cases,
                 init_method=f"file://{rdv}", timeout=60.0,
                 join_timeout=180)


@pytest.mark.parametrize("case", CASES, ids=_key)
def test_process_mesh_on_ties_matches_reference(ref, procs, case):
    key = _key(case)
    n = len(procs)
    y = np.concatenate([p[key][0] for p in procs])
    assert _rel(y, ref[f"{key}/y_mesh"]) < 1e-5
    for p in procs:
        assert abs(p[key][1] - float(ref[f"{key}/aux_mesh"])) < 1e-6
    want = ref[f"{key}/eids"].reshape(n, -1, case[1])
    for r, p in enumerate(procs):
        assert np.array_equal(p[key][2], want[r])
