"""The port's split-island MoE (EP over one mesh axis, or none) and its int8
dispatch against the reference's ``moe_apply``.

``smoke_config("mixtral-8x7b")`` in f32 with the experts and mesh of each
layout, chosen by ``choose_ep_axes`` on both sides:

* ``pod``: 4 experts on (2, 3, 1): 4 divides neither 6 nor 3 but 2, so EP
  runs over the slow axis alone (mixtral's production layout), through the
  rotation (``flash``) and the plan, exact and int8;
* ``data``: 2 experts on (2, 2, 1): EP over the fast axis alone (dbrx's);
* ``none``: 4 experts on (1, 3, 1): no EP, experts replicated.

Max relative error < 1e-5, aux absolute error < 1e-6, with and without the
kernel paths.  Parameters come from the reference's ``init_moe``; inputs
from ``np.random.default_rng``.
"""

import dataclasses
import os

import numpy as np
import pytest
import torch
from conftest import run_subprocess

from repro_torch.comm import all_to_all as pt_a2a
from repro_torch.configs import smoke_config
from repro_torch.configs.registry import MoESpec
from repro_torch.convert import load_params
from repro_torch.launch.mesh import make_mesh
from repro_torch.launch.serve import flash_plan, make_dist_context
from repro_torch.models import moe

# name -> (experts, mesh, batch, EP axes)
CASES = {"pod": (4, (2, 3, 1), 6, ("pod",)),
         "data": (2, (2, 2, 1), 4, ("data",)),
         "none": (4, (1, 3, 1), 6, None)}
# (case, impl, quantized dispatch)
RUNS = [("pod", "flash", False), ("pod", "flash", True),
        ("pod", "plan", False), ("pod", "plan", True),
        ("data", "flash", False), ("none", "flash", False)]

_JAX_SIDE = """
import dataclasses, numpy as np, jax, jax.numpy as jnp
from jax.sharding import NamedSharding, PartitionSpec as P
from repro.configs import smoke_config
from repro.configs.registry import MoESpec
from repro.core.schedulers import get_scheduler
from repro.core.traffic import ClusterSpec, moe_workload
from repro.launch.mesh import make_mesh
from repro.models.dist import DistContext, choose_ep_axes
from repro.models.moe import init_moe, moe_apply

out = {}
for name, (n_exp, shape, batch, _) in CASES.items():
    cfg = dataclasses.replace(smoke_config("mixtral-8x7b"),
                              compute_dtype="float32",
                              moe=MoESpec(num_experts=n_exp, top_k=2))
    p = init_moe(jax.random.PRNGKey(0), cfg)
    x = (np.random.default_rng(1).normal(size=(batch, 8, cfg.d_model))
         * 0.3).astype(np.float32)
    out.update({f"{name}_p_{k}": np.asarray(v) for k, v in p.items()})
    out[f"{name}_x"] = x
    mesh = make_mesh(shape, ("pod", "data", "model"))
    ep = choose_ep_axes(cfg, mesh)
    out[f"{name}_ep"] = np.array(",".join(ep or ()))
    xg = jax.device_put(jnp.asarray(x),
                        NamedSharding(mesh, P(("pod", "data"))))
    for case, impl, quant in RUNS:
        if case != name:
            continue
        plan = get_scheduler("flash").synthesize(moe_workload(
            ClusterSpec(shape[0], shape[1]), 256, 2, seed=0)) \\
            if impl == "plan" else None
        dist = DistContext(mesh=mesh, dp_axes=("pod", "data"),
                           slow_axis="pod", ep_axes=ep, a2a_impl=impl,
                           plan=plan)
        c = dataclasses.replace(cfg, quantized_dispatch=quant)
        y, aux = jax.jit(lambda pp, xx: moe_apply(c, pp, xx, dist))(p, xg)
        out[f"{case}_{impl}_{int(quant)}_y"] = np.asarray(y)
        out[f"{case}_{impl}_{int(quant)}_aux"] = np.asarray(aux)
np.savez(OUT, **out)
print("JAX_SIDE_OK")
"""


@pytest.fixture(scope="module")
def jax_side(tmp_path_factory):
    """The reference's moe_apply on fake devices, in one subprocess."""
    path = os.path.join(tmp_path_factory.mktemp("pod_ep"), "ref.npz")
    out = run_subprocess(f"CASES = {CASES!r}\nRUNS = {RUNS!r}\n"
                         f"OUT = {path!r}\n" + _JAX_SIDE)
    assert "JAX_SIDE_OK" in out
    return dict(np.load(path))


def _setup(jax_side, case, quant=False):
    n_exp, shape, _, _ = CASES[case]
    cfg = dataclasses.replace(smoke_config("mixtral-8x7b"),
                              compute_dtype="float32",
                              moe=MoESpec(num_experts=n_exp, top_k=2),
                              quantized_dispatch=quant)
    layer = moe.MoE(cfg, torch.Generator().manual_seed(0), torch.float32,
                    "cpu")
    prefix = f"{case}_p_"
    load_params(layer, {k[len(prefix):]: v for k, v in jax_side.items()
                        if k.startswith(prefix)})
    mesh = make_mesh(shape, ("pod", "data", "model"), device="cpu")
    return cfg, layer, mesh, torch.from_numpy(jax_side[f"{case}_x"])


def _dist(cfg, mesh, impl, use_kernel=True):
    plan = flash_plan(mesh.shape[0], mesh.shape[1]) if impl == "plan" \
        else None
    return make_dist_context(cfg, mesh, impl, plan, use_kernel=use_kernel)


def _rel(y, ref):
    return float(np.abs(y - ref).max() / (np.abs(ref).max() + 1e-9))


@pytest.mark.parametrize("use_kernel", [True, False])
@pytest.mark.parametrize("run", RUNS, ids=["-".join(map(str, r))
                                           for r in RUNS])
def test_pod_ep_matches_reference(jax_side, run, use_kernel):
    case, impl, quant = run
    cfg, layer, mesh, x = _setup(jax_side, case, quant)
    dist = _dist(cfg, mesh, impl, use_kernel)
    assert dist.ep_axes == CASES[case][3]
    assert ",".join(dist.ep_axes or ()) == str(jax_side[f"{case}_ep"])
    with torch.no_grad():
        y, aux = moe.moe_apply(cfg, layer, x, dist)
    key = f"{case}_{impl}_{int(quant)}"
    assert _rel(y.numpy(), jax_side[f"{key}_y"]) < 1e-5
    assert abs(float(aux) - float(jax_side[f"{key}_aux"])) < 1e-6


def test_quantized_dispatch_close_to_exact(jax_side):
    """int8 over the slow axis: within (0, 0.05) of exact (the reference's
    tests/test_perf_knobs.py bound), and the same through the plan and the
    rotation, since the exchange only moves the int8 rows and scales."""
    cfg, layer, mesh, x = _setup(jax_side, "pod")
    cfg_q = dataclasses.replace(cfg, quantized_dispatch=True)
    with torch.no_grad():
        exact = moe.moe_apply(cfg, layer, x, _dist(cfg, mesh, "flash"))[0]
        quant = [moe.moe_apply(cfg_q, layer, x, _dist(cfg_q, mesh, impl))[0]
                 for impl in ("flash", "plan")]
    assert 0 < _rel(quant[0].numpy(), exact.numpy()) < 0.05
    assert torch.equal(quant[0], quant[1])


def test_quantized_dispatch_only_over_the_slow_axis(jax_side):
    """EP over a fast axis ships full-precision rows even when the config
    asks for int8 dispatch, as the reference."""
    cfg, layer, mesh, x = _setup(jax_side, "data")
    cfg_q = dataclasses.replace(cfg, quantized_dispatch=True)
    with torch.no_grad():
        ys = [moe.moe_apply(c, layer, x, _dist(c, mesh, "flash"))[0]
              for c in (cfg, cfg_q)]
    assert torch.equal(ys[0], ys[1])


def test_pod_ep_exchanges_bit_identical(jax_side):
    """Every impl name resolves to an exchange that moves the same rows:
    the rotation (direct, flash, hierarchical) and the plan agree bit for
    bit, with the kernel path and without."""
    cfg, layer, mesh, x = _setup(jax_side, "pod")
    with torch.no_grad():
        ys = [moe.moe_apply(cfg, layer, x, _dist(cfg, mesh, impl, uk))[0]
              for impl in ("direct", "flash", "hierarchical", "plan")
              for uk in (True, False)]
    for y in ys[1:]:
        assert torch.equal(y, ys[0])


def test_pod_ep_exchange_selection():
    """The split island's exchange: the rotation over the slow axis (the
    plan's stages under impl="plan"), a flat all-to-all over a fast one,
    int8 only over the slow axis."""
    cfg = smoke_config("mixtral-8x7b")
    mesh = make_mesh((2, 2, 1), ("pod", "data", "model"), device="cpu")
    island = mesh.sub(("pod", "data"))
    dist = make_dist_context(cfg, mesh, "flash")
    assert moe._pod_ep_exchange(cfg, dist, island, "pod", True).func \
        is pt_a2a.rotation_all_to_all
    assert moe._pod_ep_exchange(cfg, dist, island, "data", False).func \
        is pt_a2a.intra_all_to_all
    cfg_q = dataclasses.replace(cfg, quantized_dispatch=True)
    quant = moe._pod_ep_exchange(cfg_q, dist, island, "pod", True)
    assert not hasattr(quant, "func")
    assert moe._pod_ep_exchange(cfg_q, dist, island, "data", False).func \
        is pt_a2a.intra_all_to_all
