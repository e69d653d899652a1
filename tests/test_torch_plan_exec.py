"""The port's plan lowering and plan-driven All-to-All against the
reference's (``repro.comm.plan_exec``).

* ``lower_plan``: the port's ``DeviceSchedule`` equals the reference's
  field for field for every plan of the golden corpus, the port
  synthesizing its own plan from the same workload.
* ``plan_all_to_all`` on a local mesh equals the reference's under
  ``shard_map`` on fake devices bit for bit (the cases of
  tests/test_comm.py plus slow-axis-only EP), with and without the kernel
  path, and equals the port's ``direct``.
* ``flash``, ``hierarchical`` and the slow-axis ``rotation`` on (2, 2) and
  (2, 3) meshes equal the reference's under ``shard_map`` and the port's
  ``direct`` bit for bit.
"""

import dataclasses
import os

import numpy as np
import pytest
import torch
from conftest import run_subprocess

from repro.analysis.corpus import corpus_workloads
from repro.comm import plan_exec as ref_exec
from repro.core.schedulers import SCHEDULERS
from repro.core.schedulers import get_scheduler as ref_scheduler
from repro.core.traffic import ClusterSpec as RefClusterSpec
from repro.core.traffic import moe_workload as ref_moe_workload
from repro_torch.comm import all_to_all as pt_a2a
from repro_torch.comm.plan_exec import (
    DeviceSchedule,
    _global_rows,
    is_lowered,
    lower_plan,
    plan_all_to_all,
)
from repro_torch.core.schedulers import get_scheduler
from repro_torch.core.topology import Topology
from repro_torch.core.traffic import (
    ClusterSpec,
    Workload,
    moe_workload,
    skewed_workload,
)
from repro_torch.launch.mesh import make_mesh

CORPUS = {e["name"]: e["workload"] for e in corpus_workloads()}


def _port_workload(w):
    """The reference workload ``w`` rebuilt from the port's own classes."""
    topo = None if w.topology is None else \
        Topology.from_dict(w.topology.to_dict())
    return Workload(ClusterSpec(w.cluster.n_servers, w.cluster.m_gpus),
                    np.array(w.matrix), topo)


@pytest.mark.parametrize("algo", sorted(SCHEDULERS))
@pytest.mark.parametrize("name", sorted(CORPUS))
def test_device_schedule_matches_reference(name, algo):
    w = CORPUS[name]
    ref = ref_exec.lower_plan(ref_scheduler(algo).synthesize(w))
    got = lower_plan(get_scheduler(algo).synthesize(_port_workload(w)))
    assert isinstance(got, DeviceSchedule)
    assert dataclasses.asdict(got) == dataclasses.asdict(ref)


def test_memo_slots_are_distinct():
    """One plan lowered by both packages keeps one lowering of each type."""
    plan = ref_scheduler("flash").synthesize(
        ref_moe_workload(RefClusterSpec(4, 2), 256, 2, seed=0))
    ref = ref_exec.lower_plan(plan)
    got = lower_plan(plan)
    assert type(got) is DeviceSchedule and type(ref) is not DeviceSchedule
    assert ref_exec.lower_plan(plan) is ref and lower_plan(plan) is got
    assert is_lowered(plan) and ref_exec.is_lowered(plan)
    assert dataclasses.asdict(got) == dataclasses.asdict(ref)


def test_unpack_rows_give_each_rank_its_own_trash_block():
    """Idle stages of rank r land in block r*(p+1)+p: its own trash block,
    never a shared one and never a real block of another rank."""
    plan = get_scheduler("fanout").synthesize(
        moe_workload(ClusterSpec(4, 2), 256, 2, seed=2))
    sched = lower_plan(plan)
    p, s = sched.n_pods, sched.n_stages
    pods = tuple(q for q in range(p) for _ in range(2))
    mesh = make_mesh((p, 2), ("pod", "data"), device="cpu")
    rows = _global_rows(mesh, sched, pods, p + 1, "src_of", p,
                        "cpu").numpy()
    rows = rows.reshape(len(pods), s + 1)
    for rank, q in enumerate(pods):
        assert rows[rank, 0] == rank * (p + 1) + q
        for k in range(s):
            src = sched.src_of[k][q]
            want = p if src < 0 else src
            assert rows[rank, k + 1] == rank * (p + 1) + want
        real = rows[rank][rows[rank] % (p + 1) != p]
        assert sorted(real % (p + 1)) == list(range(p))


def _rand_matrix(n_servers, m_gpus, seed):
    n = n_servers * m_gpus
    rng = np.random.default_rng(seed)
    mat = rng.integers(1, 50, size=(n, n)).astype(float)
    np.fill_diagonal(mat, 0)
    return mat


A2A_MESHES = {"2x2": (2, 2), "2x3": (2, 3)}

CASES = [
    (2, 4, "moe", 0, "flash"),
    (2, 4, "skewed", 1, "flash"),
    (4, 2, "moe", 2, "flash"),
    (4, 2, "random", 3, "fanout"),
]

_JAX_SIDE = """
import numpy as np, jax, jax.numpy as jnp
from functools import partial
from jax.sharding import PartitionSpec as P
from repro.comm import direct_all_to_all, flash_all_to_all, \
    hierarchical_all_to_all, plan_all_to_all, rotation_all_to_all
from repro.core.schedulers import get_scheduler
from repro.core.traffic import ClusterSpec, Workload, moe_workload, \\
    skewed_workload
from repro.launch.mesh import make_mesh

def workload(pods, gpp, kind, seed):
    c = ClusterSpec(pods, gpp)
    if kind == "moe":
        return moe_workload(c, 256, 2, seed=seed)
    if kind == "skewed":
        return skewed_workload(c, 1e6, seed=seed)
    n = pods * gpp
    rng = np.random.default_rng(seed)
    mat = rng.integers(1, 50, size=(n, n)).astype(float)
    np.fill_diagonal(mat, 0)
    return Workload(c, mat)

out = {}
rng = np.random.default_rng(42)
for k, (pods, gpp, kind, seed, algo) in enumerate(CASES):
    mesh = make_mesh((pods, gpp), ("pod", "data"))
    plan = get_scheduler(algo).synthesize(workload(pods, gpp, kind, seed))
    n = pods * gpp
    x = rng.normal(size=(n * n, 3, 8)).astype(np.float32)
    spec = P(("pod", "data"))
    out[f"x{k}"] = x
    for uk in (True, False):
        f = jax.shard_map(
            partial(plan_all_to_all, slow_axis="pod", fast_axes=("data",),
                    plan=plan, use_kernel=uk),
            mesh=mesh, in_specs=spec, out_specs=spec, check_vma=False)
        out[f"plan{k}_{int(uk)}"] = np.asarray(jax.jit(f)(jnp.asarray(x)))
    f = jax.shard_map(
        partial(direct_all_to_all, slow_axis="pod", fast_axes=("data",)),
        mesh=mesh, in_specs=spec, out_specs=spec, check_vma=False)
    out[f"direct{k}"] = np.asarray(jax.jit(f)(jnp.asarray(x)))

mesh = make_mesh((4, 2), ("pod", "model"))
plan = get_scheduler("flash").synthesize(
    moe_workload(ClusterSpec(4, 1), 256, 2, seed=5))
x = np.random.default_rng(0).normal(size=(16, 6)).astype(np.float32)
f = jax.shard_map(
    partial(plan_all_to_all, slow_axis="pod", fast_axes=(), plan=plan),
    mesh=mesh, in_specs=P("pod"), out_specs=P("pod"), check_vma=False)
out["x_slow"] = x
out["plan_slow"] = np.asarray(jax.jit(f)(jnp.asarray(x)))
f = jax.shard_map(partial(rotation_all_to_all, axis="pod"), mesh=mesh,
                  in_specs=P("pod"), out_specs=P("pod"), check_vma=False)
out["rot_slow"] = np.asarray(jax.jit(f)(jnp.asarray(x)))

rng = np.random.default_rng(7)
for name, shape in A2A_MESHES.items():
    mesh = make_mesh(shape, ("pod", "data"))
    n = shape[0] * shape[1]
    spec = P(("pod", "data"))
    x = rng.normal(size=(n * n, 3, 4)).astype(np.float32)
    out[f"x_{name}"] = x
    for impl, fn in (("flash", flash_all_to_all),
                     ("hierarchical", hierarchical_all_to_all)):
        f = jax.shard_map(partial(fn, slow_axis="pod", fast_axes=("data",)),
                          mesh=mesh, in_specs=spec, out_specs=spec,
                          check_vma=False)
        out[f"{impl}_{name}"] = np.asarray(jax.jit(f)(jnp.asarray(x)))
    xr = rng.normal(size=(n * shape[0], 5)).astype(np.float32)
    out[f"xr_{name}"] = xr
    f = jax.shard_map(partial(rotation_all_to_all, axis="pod"), mesh=mesh,
                      in_specs=spec, out_specs=spec, check_vma=False)
    out[f"rotation_{name}"] = np.asarray(jax.jit(f)(jnp.asarray(xr)))
np.savez(OUT, **out)
print("JAX_SIDE_OK")
"""


@pytest.fixture(scope="module")
def jax_side(tmp_path_factory):
    """The reference's exchanges on 8 fake devices, in one subprocess."""
    path = os.path.join(tmp_path_factory.mktemp("plan_exec"), "ref.npz")
    out = run_subprocess(f"CASES = {CASES!r}\nA2A_MESHES = {A2A_MESHES!r}\n"
                         f"OUT = {path!r}\n" + _JAX_SIDE)
    assert "JAX_SIDE_OK" in out
    return dict(np.load(path))


def _port_plan(pods, gpp, kind, seed, algo):
    c = ClusterSpec(pods, gpp)
    if kind == "moe":
        w = moe_workload(c, 256, 2, seed=seed)
    elif kind == "skewed":
        w = skewed_workload(c, 1e6, seed=seed)
    else:
        w = Workload(c, _rand_matrix(pods, gpp, seed))
    return get_scheduler(algo).synthesize(w)


@pytest.mark.parametrize("use_kernel", [True, False])
@pytest.mark.parametrize("case", range(len(CASES)))
def test_plan_all_to_all_bit_exact_vs_reference(jax_side, case, use_kernel):
    pods, gpp, kind, seed, algo = CASES[case]
    n = pods * gpp
    mesh = make_mesh((pods, gpp), ("pod", "data"), device="cpu")
    plan = _port_plan(*CASES[case])
    x = torch.from_numpy(jax_side[f"x{case}"]).reshape(n, n, 3, 8)
    got = plan_all_to_all(x, "pod", ("data",), mesh=mesh, plan=plan,
                          use_kernel=use_kernel)
    ref = jax_side[f"plan{case}_{int(use_kernel)}"]
    assert np.array_equal(got.reshape(n * n, 3, 8).numpy(), ref)
    direct = pt_a2a.direct_all_to_all(x, "pod", ("data",), mesh=mesh)
    assert torch.equal(got, direct)
    assert np.array_equal(direct.reshape(n * n, 3, 8).numpy(),
                          jax_side[f"direct{case}"])


def test_plan_all_to_all_slow_only_vs_reference(jax_side):
    """EP over the slow axis alone: the plan path against the reference's
    plan path and its rotation schedule."""
    mesh = make_mesh((4,), ("pod",), device="cpu")
    plan = get_scheduler("flash").synthesize(
        moe_workload(ClusterSpec(4, 1), 256, 2, seed=5))
    x = torch.from_numpy(jax_side["x_slow"]).reshape(4, 4, 6)
    a2a = pt_a2a.resolve_all_to_all(mesh=mesh, slow_axis="pod",
                                    ep_axes=("pod",), impl="plan", plan=plan)
    got = a2a(x).reshape(16, 6).numpy()
    assert np.array_equal(got, jax_side["plan_slow"])
    assert np.array_equal(got, jax_side["rot_slow"])


@pytest.mark.parametrize("impl", ["flash", "hierarchical"])
@pytest.mark.parametrize("mname", sorted(A2A_MESHES))
def test_two_tier_impl_bit_exact_vs_reference(jax_side, impl, mname):
    shape = A2A_MESHES[mname]
    n = shape[0] * shape[1]
    mesh = make_mesh(shape, ("pod", "data"), device="cpu")
    x = torch.from_numpy(jax_side[f"x_{mname}"]).reshape(n, n, 3, 4)
    got = pt_a2a.all_to_all_by_name(impl)(x, "pod", ("data",), mesh=mesh)
    assert np.array_equal(got.reshape(n * n, 3, 4).numpy(),
                          jax_side[f"{impl}_{mname}"])
    assert torch.equal(got, pt_a2a.direct_all_to_all(x, "pod", ("data",),
                                                     mesh=mesh))


@pytest.mark.parametrize("mname", sorted(A2A_MESHES))
def test_rotation_bit_exact_vs_reference(jax_side, mname):
    """EP over the slow axis alone: the rotation schedule, as
    ``resolve_all_to_all`` selects it for every impl but ``plan``."""
    shape = A2A_MESHES[mname]
    n, p = shape[0] * shape[1], shape[0]
    mesh = make_mesh(shape, ("pod", "data"), device="cpu")
    x = torch.from_numpy(jax_side[f"xr_{mname}"]).reshape(n, p, 5)
    a2a = pt_a2a.resolve_all_to_all(mesh=mesh, slow_axis="pod",
                                    ep_axes=("pod",), impl="flash")
    assert a2a.func is pt_a2a.rotation_all_to_all
    got = a2a(x)
    assert np.array_equal(got.reshape(n * p, 5).numpy(),
                          jax_side[f"rotation_{mname}"])
    assert torch.equal(got, pt_a2a.direct_all_to_all(x, "pod", (),
                                                     mesh=mesh))
    y = torch.arange(n * shape[1] * 2.0).reshape(n, shape[1], 2)
    assert torch.equal(
        pt_a2a.fast_only_all_to_all(y, "pod", "data", mesh=mesh),
        pt_a2a.intra_all_to_all(y, "data", mesh=mesh))


def test_resolve_all_to_all_rules():
    """The reference's selection rules; an unknown impl raises and is
    never replaced by another."""
    mesh = make_mesh((2, 2), ("pod", "data"), device="cpu")
    plan = get_scheduler("flash").synthesize(
        moe_workload(ClusterSpec(2, 2), 256, 2, seed=0))
    kw = dict(mesh=mesh, slow_axis="pod", ep_axes=("pod", "data"))
    assert pt_a2a.resolve_all_to_all(**kw, impl="auto", plan=plan) \
        .func is plan_all_to_all
    assert pt_a2a.resolve_all_to_all(**kw, impl="auto").func \
        is pt_a2a.direct_all_to_all
    hetero = Topology.from_cluster(ClusterSpec(2, 2)).degrade_nic(
        0, 0, 0.5, "both")
    for impl, extra, fn in (
            ("flash", {}, pt_a2a.flash_all_to_all),
            ("hierarchical", {}, pt_a2a.hierarchical_all_to_all),
            ("auto", {"topology": hetero}, pt_a2a.flash_all_to_all)):
        assert pt_a2a.resolve_all_to_all(**kw, impl=impl, **extra).func \
            is fn
    for impl in ("direct", "flash", "hierarchical", "auto"):
        assert pt_a2a.resolve_all_to_all(
            mesh=mesh, slow_axis="pod", ep_axes=("pod",), impl=impl).func \
            is pt_a2a.rotation_all_to_all
    with pytest.raises(ValueError):
        pt_a2a.resolve_all_to_all(mesh=mesh, slow_axis="pod",
                                  ep_axes=("pod",), impl="rotation")
    with pytest.raises(ValueError):
        pt_a2a.resolve_all_to_all(**kw, impl="nope")
    with pytest.raises(ValueError):
        pt_a2a.resolve_all_to_all(**kw, impl="plan")
    assert pt_a2a.resolve_all_to_all(mesh=mesh, slow_axis="pod", ep_axes=(),
                                     impl="direct") is None
    intra = pt_a2a.resolve_all_to_all(mesh=mesh, slow_axis="pod",
                                      ep_axes=("data",), impl="direct")
    assert intra.func is pt_a2a.intra_all_to_all
    assert pt_a2a.available_all_to_all_impls() == \
        ["direct", "flash", "hierarchical", "plan"]


def test_local_mesh_collectives_per_rank():
    """The stacked collectives against per-rank loops over a (2, 3, 2)
    mesh: ranks are row-major over the axes, as the JAX mesh's devices."""
    from repro_torch.launch import mesh as lm

    mesh = make_mesh((2, 3, 2), ("pod", "data", "model"), device="cpu")
    coords = [(a, b, c) for a in range(2) for b in range(3)
              for c in range(2)]
    rank_of = {co: r for r, co in enumerate(coords)}
    assert lm.axis_index(mesh, "data").tolist() == [c[1] for c in coords]

    x = torch.arange(12 * 6 * 5, dtype=torch.float32).reshape(12, 6, 5)
    out = lm.all_to_all(mesh, x, ("pod", "data"))
    for r, (a, b, c) in enumerate(coords):
        for j in range(6):                 # chunk j from combined index j
            src = rank_of[(j // 3, j % 3, c)]
            assert torch.equal(out[r, j], x[src, a * 3 + b])

    pairs = [(0, 2), (2, 1)]               # data 1 and 2 send, data 0 idle
    out = lm.ppermute(mesh, x, "data", pairs)
    for r, (a, b, c) in enumerate(coords):
        src = {d: s for s, d in pairs}.get(b)
        want = torch.zeros_like(x[r]) if src is None \
            else x[rank_of[(a, src, c)]]
        assert torch.equal(out[r], want)

    m = lm.pmean(mesh, x, ("pod", "data"))
    for r, (a, b, c) in enumerate(coords):
        group = [rank_of[(i, j, c)] for i in range(2) for j in range(3)]
        assert torch.allclose(m[r], x[group].mean(0))
    assert mesh.sub(("pod", "data")) is mesh.sub(("pod", "data"))
    with pytest.raises(ValueError):
        mesh.sub(("data", "pod"))
