"""The port's process mesh: 4 gloo processes on a (pod 2, data 2, model 1)
mesh, one rank each, against the stacked ``LocalMesh`` and the reference's
``shard_map`` on 4 fake devices, on the same per-rank inputs.

* ``all_to_all`` over ``pod``, ``data``, ``("pod", "data")`` and
  ``("data", "pod")`` (f32, bf16, int8), ``ppermute`` (a swap, and a partial
  permutation whose idle ranks get zeros), ``axis_index``, ``psum_bf16``
  and ``ef_compressed_psum``: bit for bit against ``LocalMesh`` and the
  reference (the error-feedback sum within 1e-6 of the reference's, as
  ``test_torch_train.py`` holds the stacked form, the scale differing by an
  ulp).
* ``pmean``: within a relative 1e-6 (its all_reduce sums in the backend's
  order).
* Every exchange impl (``direct``, ``flash``, ``hierarchical``,
  ``rotation`` and ``plan`` with and without the kernel path): bit for bit
  against both.
* Each process unpacks the plan exchange into its own ``p + 1`` blocks, the
  last its trash block.
* ``gather_tensor(shard_tensor(x))`` is ``x`` in every process.
* A collective that one rank never joins fails the run within the
  timeout; ``_moe_pod_ep`` (and int8 dispatch with it) runs on a
  ``ProcessMesh`` on each process's shard of the experts and refuses a
  whole stack where EP gives it ``E_loc``.

Each process is started with the ``spawn`` method and joins through a
``file://`` rendezvous under the test's temporary directory.
"""

import re
import time

import numpy as np
import pytest
import torch
from conftest import run_subprocess

from repro_torch.comm import all_to_all as pt_a2a
from repro_torch.comm import plan_exec
from repro_torch.comm.collectives import ef_compressed_psum, psum_bf16
from repro_torch.launch import mesh as M
from repro_torch.launch.procs import spawn
from repro_torch.launch.serve import flash_plan
from repro_torch.launch.shardings import gather_tensor, shard_tensor

SHAPE = (2, 2, 1)
AXES = ("pod", "data", "model")
TIMEOUT_S = 60.0

# all_to_all cases: name -> (axes, input key)
A2A = {
    "a2a_pod": (("pod",), "x"),
    "a2a_data": (("data",), "x"),
    "a2a_pod_data": (("pod", "data"), "x"),
    "a2a_data_pod": (("data", "pod"), "x"),
    "a2a_bf16": (("pod", "data"), "xb"),
    "a2a_int8": (("data",), "xi"),
}
PPERMUTE = {"ppermute_swap": ("pod", ((0, 1), (1, 0))),
            "ppermute_partial": ("data", ((0, 1),))}
SPECS = [(("pod", "data"), None, None), ("data", "pod", None),
         (None, None, None), ("pod", None, "data")]
IMPLS = ("direct", "flash", "hierarchical", "plan_kernel", "plan_plain",
         "rotation")


def _inputs():
    rng = np.random.default_rng(11)
    x = rng.normal(size=(4, 4, 3, 8)).astype(np.float32)
    return {
        "x": x,
        "xb": x * 3.0,            # cast to bf16 on both sides
        "xi": rng.integers(-127, 128, size=(4, 4, 5)).astype(np.int8),
        "xr": rng.normal(size=(4, 2, 5)).astype(np.float32),
        "g": rng.normal(size=(4, 6, 5)).astype(np.float32),
        "err": (rng.normal(size=(4, 6, 5)) * 0.01).astype(np.float32),
    }


_JAX_SIDE = """
import numpy as np, jax, jax.numpy as jnp
from functools import partial
from jax import lax
from jax.sharding import PartitionSpec as P
from repro.comm import direct_all_to_all, flash_all_to_all, \\
    hierarchical_all_to_all, plan_all_to_all, rotation_all_to_all
from repro.comm.collectives import ef_compressed_psum, psum_bf16
from repro.core.schedulers import get_scheduler
from repro.core.traffic import ClusterSpec, moe_workload
from repro.launch.mesh import make_mesh

inp = dict(np.load(INP))
mesh = make_mesh((2, 2, 1), ("pod", "data", "model"))
spec = P(("pod", "data"))
plan = get_scheduler("flash").synthesize(
    moe_workload(ClusterSpec(2, 2), tokens_per_gpu=2048, bytes_per_token=2,
                 seed=0))

def run(fn, *xs, n_out=1):
    f = jax.shard_map(lambda *a: fn(*(v[0] for v in a)), mesh=mesh,
                      in_specs=(spec,) * len(xs),
                      out_specs=spec if n_out == 1 else (spec,) * n_out,
                      check_vma=False)
    return jax.jit(f)(*(jnp.asarray(v) for v in xs))

def one(fn):
    return lambda *a: fn(*a)[None]

out = {}
for name, (axes, key) in A2A.items():
    v = inp[key]
    if key == "xb":
        v = jnp.asarray(v).astype(jnp.bfloat16)
    y = run(one(lambda a: lax.all_to_all(a, axes, 0, 0, tiled=True)), v)
    out[name] = np.asarray(jnp.asarray(y).astype(jnp.float32)) \\
        if key == "xb" else np.asarray(y)
for name, (axis, pairs) in PPERMUTE.items():
    out[name] = np.asarray(run(one(lambda a: lax.ppermute(a, axis, pairs)),
                               inp["x"]))
for axis in ("pod", "data"):
    out["axis_index_" + axis] = np.asarray(run(
        lambda a: lax.axis_index(axis)[None].astype(jnp.int32), inp["x"]))
out["pmean"] = np.asarray(run(one(lambda a: lax.pmean(a, ("pod", "data"))),
                              inp["x"]))
out["psum_bf16"] = np.asarray(run(one(lambda a: psum_bf16(a, "pod")),
                                  inp["g"]))
tot, err = run(lambda g, e: tuple(t[None] for t in ef_compressed_psum(
    g, "data", e)), inp["g"], inp["err"], n_out=2)
out["ef_total"], out["ef_error"] = np.asarray(tot), np.asarray(err)
kw = dict(slow_axis="pod", fast_axes=("data",))
for name, fn in (("direct", direct_all_to_all), ("flash", flash_all_to_all),
                 ("hierarchical", hierarchical_all_to_all),
                 ("plan_kernel", partial(plan_all_to_all, plan=plan,
                                         use_kernel=True)),
                 ("plan_plain", partial(plan_all_to_all, plan=plan,
                                        use_kernel=False))):
    out[name] = np.asarray(run(one(partial(fn, **kw)), inp["x"]))
out["rotation"] = np.asarray(run(one(partial(rotation_all_to_all,
                                             axis="pod")), inp["xr"]))
np.savez(OUT, **out)
print("JAX_SIDE_OK")
"""


def _impl(name, mesh, plan):
    """The port's exchange ``name`` on ``mesh`` (x of the rank stack)."""
    if name == "rotation":
        return lambda x: pt_a2a.rotation_all_to_all(x, "pod", mesh=mesh)
    if name.startswith("plan"):
        return lambda x: plan_exec.plan_all_to_all(
            x, "pod", ("data",), mesh=mesh, plan=plan,
            use_kernel=name == "plan_kernel")
    fn = pt_a2a.all_to_all_by_name(name)
    return lambda x: fn(x, "pod", ("data",), mesh=mesh)


def _run_all(mesh, inp: dict, plan) -> dict:
    """Every collective and exchange of the module on ``mesh``, given the
    stacked inputs of the ranks it holds.  Returns numpy arrays."""
    t = {k: torch.from_numpy(v) for k, v in inp.items()}
    out = {}
    for name, (axes, key) in A2A.items():
        v = t[key].to(torch.bfloat16) if key == "xb" else t[key]
        y = M.all_to_all(mesh, v, axes)
        out[name] = (y.float() if key == "xb" else y).numpy()
    for name, (axis, pairs) in PPERMUTE.items():
        out[name] = M.ppermute(mesh, t["x"], axis, pairs).numpy()
    for axis in ("pod", "data"):
        out["axis_index_" + axis] = M.axis_index(mesh, axis).numpy()
    out["pmean"] = M.pmean(mesh, t["x"], ("pod", "data")).numpy()
    out["psum_bf16"] = psum_bf16(mesh, t["g"], "pod").numpy()
    tot, err = ef_compressed_psum(mesh, t["g"], "data", t["err"])
    out["ef_total"], out["ef_error"] = tot.numpy(), err.numpy()
    for name in IMPLS:
        x = t["xr"] if name == "rotation" else t["x"]
        out[name] = _impl(name, mesh, plan)(x).numpy()
    return out


def _rank_work(mesh, inp, plan):
    """One process: the module's cases on its own rank's inputs, the
    unpack's output blocks of the plan exchange, and the single-axis MoE
    paths on its shard and on the whole stack."""
    import dataclasses

    from repro_torch.configs import smoke_config
    from repro_torch.models import moe
    from repro_torch.models.dist import DistContext

    own = {k: v[mesh.rank:mesh.rank + 1] for k, v in inp.items()}
    out = _run_all(mesh, own, plan)

    unpacks = []
    real = plan_exec.a2a_unpack_ref

    def spy(y, idx, n_out_blocks, block_rows):
        unpacks.append((n_out_blocks, idx.min().item(), idx.max().item(),
                        idx.numel()))
        return real(y, idx, n_out_blocks, block_rows)

    plan_exec.a2a_unpack_ref = spy
    try:
        _impl("plan_plain", mesh, plan)(torch.from_numpy(own["x"]))
    finally:
        plan_exec.a2a_unpack_ref = real
    out["unpacks"] = unpacks

    cfg = dataclasses.replace(smoke_config("mixtral-8x7b"),
                              compute_dtype="float32")
    layer = moe.MoE(cfg, torch.Generator().manual_seed(0), torch.float32,
                    "cpu")
    x = torch.zeros(2, 4, cfg.d_model)
    refusals, shard_runs = [], []
    for ep, quantized in ((("pod",), False), (("data",), True), (None, False)):
        dist = DistContext(mesh=mesh, dp_axes=("pod", "data"),
                           slow_axis="pod", ep_axes=ep, a2a_impl="flash")
        c = dataclasses.replace(cfg, quantized_dispatch=quantized)
        try:
            moe.moe_apply(c, layer, x, dist)
            refusals.append(None)
        except ValueError as e:
            refusals.append(str(e))
        shard = moe.MoE(cfg, torch.Generator().manual_seed(0),
                        torch.float32, "cpu")
        for name in ("w_gate", "w_up", "w_down"):
            setattr(shard, name, torch.nn.Parameter(shard_tensor(
                getattr(layer, name).detach(), (ep and ep[0], None, None),
                mesh).clone()))
        y, aux = moe.moe_apply(c, shard, x, dist)
        shard_runs.append(bool(torch.isfinite(y).all())
                          and tuple(y.shape) == tuple(x.shape))
    out["refusals"], out["shard_runs"] = refusals, shard_runs

    x = torch.arange(8 * 4 * 2, dtype=torch.float32).reshape(8, 4, 2)
    out["round_trips"] = [
        torch.equal(gather_tensor(shard_tensor(x, spec, mesh), spec, mesh), x)
        for spec in SPECS]
    return out


def _mismatched(mesh):
    """Both ranks meet in one collective; then rank 0 calls one that rank 1
    never joins."""
    M.pmean(mesh, torch.ones(1, 1), "pod")
    if mesh.rank == 0:
        M.pmean(mesh, torch.ones(1, 1), "pod")
    else:
        time.sleep(30)
    return None


@pytest.fixture(scope="module")
def inputs():
    return _inputs()


@pytest.fixture(scope="module")
def jax_side(tmp_path_factory, inputs):
    """The reference's collectives and exchanges under ``shard_map`` on 4
    fake devices, in one subprocess."""
    d = tmp_path_factory.mktemp("process_mesh")
    inp, out = str(d / "inp.npz"), str(d / "ref.npz")
    np.savez(inp, **inputs)
    code = (f"A2A = {A2A!r}\nPPERMUTE = {PPERMUTE!r}\nINP = {inp!r}\n"
            f"OUT = {out!r}\n" + _JAX_SIDE)
    assert "JAX_SIDE_OK" in run_subprocess(code, n_devices=4)
    return dict(np.load(out))


@pytest.fixture(scope="module")
def plan():
    return flash_plan(2, 2, seed=0)


@pytest.fixture(scope="module")
def local(inputs, plan):
    mesh = M.make_mesh(SHAPE, AXES, device="cpu")
    return _run_all(mesh, inputs, plan)


@pytest.fixture(scope="module")
def procs(tmp_path_factory, inputs, plan):
    """The 4 processes' results, by rank."""
    rdv = tmp_path_factory.mktemp("rdv") / "store"
    return spawn(_rank_work, SHAPE, AXES, "gloo", "cpu", inputs, plan,
                 init_method=f"file://{rdv}", timeout=TIMEOUT_S,
                 join_timeout=120)


def _gathered(procs, key):
    return np.concatenate([r[key] for r in procs])


EXACT = sorted(list(A2A) + list(PPERMUTE) + ["axis_index_pod",
                                              "axis_index_data",
                                              "psum_bf16"] + list(IMPLS))


@pytest.mark.parametrize("key", EXACT)
def test_bit_exact_against_local_mesh_and_reference(procs, local, jax_side,
                                                    key):
    got = _gathered(procs, key)
    assert np.array_equal(got, local[key]), key
    assert np.array_equal(got.astype(jax_side[key].dtype), jax_side[key]), \
        key


def test_ppermute_idle_ranks_get_zeros(procs):
    got = _gathered(procs, "ppermute_partial")
    # data coordinate 0 receives nothing: ranks 0 and 2
    assert not got[[0, 2]].any() and got[[1, 3]].any()


def test_exchanges_match_direct(procs):
    direct = _gathered(procs, "direct")
    for name in ("flash", "hierarchical", "plan_kernel", "plan_plain"):
        assert np.array_equal(_gathered(procs, name), direct), name


def test_error_feedback_sum(procs, local, jax_side):
    """Bit for bit against the stacked form; within 1e-6 of the largest
    carried value against the reference (its scale differs by an ulp)."""
    scale = np.abs(local["ef_total"]).max()
    for key in ("ef_total", "ef_error"):
        got = _gathered(procs, key)
        assert np.array_equal(got, local[key]), key
        assert np.abs(got - jax_side[key]).max() <= 1e-6 * scale, key


def test_pmean_within_rounding(procs, local, jax_side):
    """The all_reduce's summation order is gloo's: within a relative 1e-6
    of the stacked mean and of the reference's."""
    got = _gathered(procs, "pmean")
    for want in (local["pmean"], jax_side["pmean"]):
        assert np.abs(got - want).max() <= 1e-6 * np.abs(want).max()


def test_one_trash_block_per_process(procs, plan):
    """Each process's unpack scatters its own row (one block a stage, and
    the intra-pod block) into ``p + 1`` blocks of its own: its pods' slots
    and, for idle stages, its trash block ``p``."""
    p = SHAPE[0]
    stages = plan_exec.lower_plan(plan, n_pods=p).n_stages
    for r in procs:
        (n_out, lo, hi, n_idx), = r["unpacks"]
        assert (n_out, n_idx) == (p + 1, stages + 1)
        assert 0 <= lo and hi <= p


def test_gather_inverts_shard_on_processes(procs):
    """Each process cuts its slice (``shard_tensor``) and every process
    gathers the whole back (``gather_tensor``) over the spec's groups."""
    for r in procs:
        assert r["round_trips"] == [True] * len(SPECS)


def test_single_axis_moe_refused_on_processes(procs):
    """The single-axis forms run on processes, each on its shard of the
    experts (``test_torch_pod_ep_procs.py`` holds them against the
    reference); a process handed the whole stack where EP gives it
    ``E_loc`` experts is refused, and with no EP the whole stack is its
    shard."""
    for r in procs:
        assert r["shard_runs"] == [True, True, True]
        for msg in r["refusals"][:2]:
            assert msg is not None and "ProcessMesh" in msg
        assert r["refusals"][2] is None


def test_mismatched_collective_fails_within_the_timeout(tmp_path):
    rdv = tmp_path / "store"
    t0 = time.perf_counter()
    with pytest.raises(Exception) as info:
        spawn(_mismatched, (2,), ("pod",), "gloo", "cpu",
              init_method=f"file://{rdv}", timeout=2.0, join_timeout=60)
    elapsed = time.perf_counter() - t0
    assert re.search(r"(?i)time[d ]*out", str(info.value)), info.value
    assert elapsed < 25, elapsed


def test_local_mesh_helpers():
    """``local_size`` / ``local_coords`` of a ``LocalMesh`` are its whole
    stack; ``make_production_mesh`` needs an explicit backend for
    processes."""
    mesh = M.make_mesh(SHAPE, AXES, device="cpu")
    assert mesh.local_size == 4
    assert np.array_equal(mesh.local_coords(), mesh.coords())
    with pytest.raises(ValueError, match="backend"):
        M.make_production_mesh(multi_pod=True, process=True, device="cpu")
    with pytest.raises(ValueError, match="nccl"):
        from repro_torch.launch.procs import init_process_mesh
        init_process_mesh((2,), ("pod",), "nccl", "cpu", rank=0,
                          world_size=2)
