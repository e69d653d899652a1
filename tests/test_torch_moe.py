"""The port's MoE layer against the reference's ``moe_apply``.

``smoke_config("megatron-moe-32e")`` in f32: the island with ``plan`` and
``direct`` on meshes (2, 2, 1) and (2, 2, 2) against the reference's
``shard_map`` island on fake devices, and the one-rank path against the
reference's ``dist=None`` path.  Max relative error < 1e-5, aux absolute
error < 1e-6.  Parameters come from the reference's ``init_moe``; inputs
from ``np.random.default_rng``.
"""

import dataclasses
import os

import jax.numpy as jnp
import numpy as np
import pytest
import torch
from conftest import run_subprocess

from repro.configs import smoke_config as ref_smoke_config
from repro.models import moe as ref_moe
from repro_torch.configs import smoke_config
from repro_torch.configs.registry import MoESpec
from repro_torch.convert import load_params
from repro_torch.core.schedulers import get_scheduler
from repro_torch.core.traffic import ClusterSpec, moe_workload
from repro_torch.launch.mesh import make_mesh
from repro_torch.launch.serve import make_dist_context
from repro_torch.models import moe
from repro_torch.models.dist import DistContext

ARCH = "megatron-moe-32e"
MESHES = {"2x2x1": (2, 2, 1), "2x2x2": (2, 2, 2)}

_JAX_SIDE = """
import dataclasses, numpy as np, jax, jax.numpy as jnp
from jax.sharding import NamedSharding, PartitionSpec as P
from repro.configs import smoke_config
from repro.core.schedulers import get_scheduler
from repro.core.traffic import ClusterSpec, moe_workload
from repro.launch.mesh import make_mesh
from repro.models.dist import DistContext
from repro.models.moe import init_moe, moe_apply

cfg = dataclasses.replace(smoke_config("megatron-moe-32e"),
                          compute_dtype="float32")
p = init_moe(jax.random.PRNGKey(0), cfg)
x = (np.random.default_rng(1).normal(size=(8, 16, cfg.d_model))
     * 0.3).astype(np.float32)
plan = get_scheduler("flash").synthesize(
    moe_workload(ClusterSpec(2, 2), 256, 2, seed=0))
out = {f"p_{k}": np.asarray(v) for k, v in p.items()}
out["x"] = x
y, aux = moe_apply(cfg, p, jnp.asarray(x), None)
out["y_local"], out["aux_local"] = np.asarray(y), np.asarray(aux)
for mname, shape in MESHES.items():
    mesh = make_mesh(shape, ("pod", "data", "model"))
    xg = jax.device_put(jnp.asarray(x),
                        NamedSharding(mesh, P(("pod", "data"))))
    for impl in ("plan", "direct"):
        dist = DistContext(mesh=mesh, dp_axes=("pod", "data"),
                           slow_axis="pod", ep_axes=("pod", "data"),
                           a2a_impl=impl,
                           plan=plan if impl == "plan" else None)
        y, aux = jax.jit(lambda pp, xx: moe_apply(cfg, pp, xx, dist))(p, xg)
        out[f"y_{impl}_{mname}"] = np.asarray(y)
        out[f"aux_{impl}_{mname}"] = np.asarray(aux)
np.savez(OUT, **out)
print("JAX_SIDE_OK")
"""


@pytest.fixture(scope="module")
def jax_side(tmp_path_factory):
    """The reference's moe_apply, local and on 8 fake devices, in one
    subprocess."""
    path = os.path.join(tmp_path_factory.mktemp("moe"), "ref.npz")
    out = run_subprocess(f"MESHES = {MESHES!r}\nOUT = {path!r}\n"
                         + _JAX_SIDE)
    assert "JAX_SIDE_OK" in out
    return dict(np.load(path))


def _cfg():
    return dataclasses.replace(smoke_config(ARCH), compute_dtype="float32")


def _port_moe(cfg, ref):
    layer = moe.MoE(cfg, torch.Generator().manual_seed(0), torch.float32,
                    "cpu")
    return load_params(layer, {k[2:]: v for k, v in ref.items()
                               if k.startswith("p_")})


def _plan():
    return get_scheduler("flash").synthesize(
        moe_workload(ClusterSpec(2, 2), 256, 2, seed=0))


def _check(y, aux, y_ref, aux_ref):
    y = y.numpy()
    err = np.abs(y - y_ref).max() / (np.abs(y_ref).max() + 1e-9)
    assert err < 1e-5, err
    assert abs(float(aux) - float(aux_ref)) < 1e-6


def test_local_path_matches_reference(jax_side):
    cfg = _cfg()
    layer = _port_moe(cfg, jax_side)
    with torch.no_grad():
        y, aux = moe.moe_apply(cfg, layer, torch.from_numpy(jax_side["x"]))
    _check(y, aux, jax_side["y_local"], jax_side["aux_local"])


@pytest.mark.parametrize("use_kernel", [True, False])
@pytest.mark.parametrize("impl", ["plan", "direct"])
@pytest.mark.parametrize("mname", sorted(MESHES))
def test_island_matches_reference(jax_side, mname, impl, use_kernel):
    cfg = _cfg()
    layer = _port_moe(cfg, jax_side)
    mesh = make_mesh(MESHES[mname], ("pod", "data", "model"), device="cpu")
    dist = make_dist_context(cfg, mesh, impl,
                             _plan() if impl == "plan" else None,
                             use_kernel=use_kernel)
    assert dist.ep_axes == ("pod", "data") == dist.dp_axes
    with torch.no_grad():
        y, aux = moe.moe_apply(cfg, layer, torch.from_numpy(jax_side["x"]),
                               dist)
    _check(y, aux, jax_side[f"y_{impl}_{mname}"],
           jax_side[f"aux_{impl}_{mname}"])


def test_plan_island_bit_identical_to_direct(jax_side):
    cfg = _cfg()
    layer = _port_moe(cfg, jax_side)
    mesh = make_mesh((2, 2, 1), ("pod", "data", "model"), device="cpu")
    x = torch.from_numpy(jax_side["x"])
    with torch.no_grad():
        outs = [moe.moe_apply(cfg, layer, x,
                              make_dist_context(cfg, mesh, impl, plan))
                for impl, plan in (("plan", _plan()), ("direct", None))]
    assert torch.equal(outs[0][0], outs[1][0])
    assert torch.equal(outs[0][1], outs[1][1])


@pytest.mark.parametrize("n_tokens", [1, 7, 64, 511, 1023, 1024, 4096])
@pytest.mark.parametrize("arch", ["megatron-moe-32e", "mixtral-8x7b",
                                  "dbrx-132b"])
def test_capacity_matches_reference(arch, n_tokens):
    for full in (True, False):
        cfg = smoke_config(arch)
        ref_cfg = ref_smoke_config(arch)
        if full:
            from repro.configs import get_config as ref_get
            from repro_torch.configs import get_config
            cfg, ref_cfg = get_config(arch), ref_get(arch)
        e = cfg.moe.num_experts
        assert moe._capacity(cfg, n_tokens, e) == \
            ref_moe._capacity(ref_cfg, n_tokens, e)


@pytest.mark.parametrize("capacity", [2, 8, 64])
def test_dispatch_and_combine_match_reference(capacity):
    """Slots, keep flags, the buffer and the combine, including dropped
    (token, choice) pairs when the capacity overflows."""
    rng = np.random.default_rng(capacity)
    t, k, e, d = 40, 2, 4, 6
    x = rng.normal(size=(t, d)).astype(np.float32)
    eids = np.stack([rng.permutation(e)[:k] for _ in range(t)]).astype(
        np.int32)
    gates = rng.random(size=(t, k)).astype(np.float32)
    buf_r, slot_r, keep_r = ref_moe._dispatch(jnp.asarray(x),
                                              jnp.asarray(eids), capacity, e)
    buf, slot, keep = moe._dispatch(torch.from_numpy(x)[None],
                                    torch.from_numpy(eids).long()[None],
                                    capacity, e)
    keep_r = np.asarray(keep_r)
    assert np.array_equal(keep[0].numpy(), keep_r)
    assert np.array_equal(slot[0].numpy()[keep_r], np.asarray(slot_r)[keep_r])
    assert np.array_equal(buf[0].numpy(), np.asarray(buf_r))
    y_buf = rng.normal(size=(e * capacity, d)).astype(np.float32)
    out_r = ref_moe._combine(jnp.asarray(y_buf), slot_r, keep_r,
                             jnp.asarray(gates), t, k)
    out = moe._combine(torch.from_numpy(y_buf)[None], slot, keep,
                       torch.from_numpy(gates)[None], t, k)
    assert np.abs(out[0].numpy() - np.asarray(out_r)).max() < 1e-6


def test_single_axis_ep_is_not_ported():
    """EP over one mesh axis is not ported as a fallback to another path:
    it runs the reference's split island (``_moe_pod_ep``), never the full
    island or the one-rank path, and agrees with the one-rank path when no
    token is dropped (tests/test_torch_moe_pod_ep.py holds it against the
    reference)."""
    cfg = dataclasses.replace(
        _cfg(), moe=MoESpec(num_experts=2, top_k=2, capacity_factor=4.0))
    layer = moe.MoE(cfg, torch.Generator().manual_seed(0), torch.float32,
                    "cpu")
    mesh = make_mesh((2, 2, 1), ("pod", "data", "model"), device="cpu")
    x = torch.randn(4, 2, cfg.d_model, generator=torch.Generator()
                    .manual_seed(1))
    calls = []
    real = moe._moe_pod_ep

    def spy(*args):
        calls.append(args[1].ep_axes)
        return real(*args)

    mp = pytest.MonkeyPatch()
    mp.setattr(moe, "_moe_pod_ep", spy)
    mp.setattr(moe, "_moe_island", None)   # the full island must not run
    try:
        with torch.no_grad():
            local = moe.moe_apply(cfg, layer, x)[0]
            for ep in (("pod",), ("data",), None):
                dist = DistContext(mesh=mesh, dp_axes=("pod", "data"),
                                   slow_axis="pod", ep_axes=ep,
                                   a2a_impl="direct")
                y, _ = moe.moe_apply(cfg, layer, x, dist)
                assert float((y - local).abs().max()) < 1e-6, ep
    finally:
        mp.undo()
    assert calls == [("pod",), ("data",), None]
