"""The port's training step against the reference's ``make_train_step``.

``smoke_config("megatron-moe-32e")`` in f32 (4 experts, 2 layers), the same
parameters (the reference's ``init_lm``, converted) and the same batches
(``SyntheticLM``), two steps with ``warmup_steps=1`` (step 0 runs at a rate
of 0 and step 1 at the peak, so both the moments and an update are
compared).  The reference runs on 4 fake CPU devices in one subprocess; its
gradients are read where its step hands them to ``adamw_update``, as are
the port's.

Cases: the (2, 2, 1) mesh (the island, EP over (pod, data), the ``flash``
exchange) and no mesh; on the mesh also ``microbatches=2``,
``grad_compression=True``, ``remat=False`` and ``bf16_ce``, and the port's
plain versions (``use_kernel=False``) against the same reference run.

Tolerances: the metrics ``loss``, ``nll``, ``aux``, ``grad_norm`` and ``lr``
within a relative 1e-5; every gradient within a relative norm of 1e-4;
every parameter after step 2 within 1e-5 of the largest value of its
tensor.  ``remat`` on and off, and two-level remat, give the same step in
the port, bit for bit.

Gradient compression rounds each gradient element to a multiple of its
tensor's quantum (max |g| / 127), so an element within the 1e-7 noise of a
rounding boundary lands one quantum apart in the two packages (2 of 254,784
elements a step here).  So the compression is first held against the
reference's on the same gradients (the same levels); end to end, the compressed
gradients may differ only by exactly one quantum, at no more than 10
elements a step, and the parameters updated from such an element within
4 x the peak rate of the reference's (one Adam step is at most about the
rate); every other element is held as above.
"""

import dataclasses
import os

import numpy as np
import pytest
import torch
from conftest import run_subprocess

from repro_torch.configs import smoke_config
from repro_torch.convert import from_jax_params
from repro_torch.data import DataConfig, SyntheticLM
from repro_torch.launch import train as pt_train
from repro_torch.launch.mesh import make_mesh

ARCH = "megatron-moe-32e"
BATCH, SEQ, STEPS = 8, 16, 2
# name -> (mesh or None, config overrides, TrainOptions overrides)
CASES = {
    "mesh": ((2, 2, 1), {}, {}),
    "none": (None, {}, {}),
    "mb2": ((2, 2, 1), {}, {"microbatches": 2}),
    "gc": ((2, 2, 1), {}, {"grad_compression": True}),
    "noremat": ((2, 2, 1), {"remat": False}, {}),
    "bf16ce": ((2, 2, 1), {"bf16_ce": True}, {}),
}
OPTIONS = {"peak_lr": 3e-4, "warmup_steps": 1, "total_steps": 10}
METRICS = ("loss", "nll", "aux", "grad_norm", "lr")

_JAX_SIDE = """
import dataclasses, numpy as np, jax, jax.numpy as jnp
from repro.configs import smoke_config
from repro.data import DataConfig, SyntheticLM
from repro.launch import train as T
from repro.launch.mesh import make_mesh
from repro.models import build_model
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
for name, (shape, over, opt_over) in CASES.items():
    cfg = dataclasses.replace(base, **over)
    opts = T.TrainOptions(**OPTIONS, **opt_over)
    mesh = make_mesh(shape, ("pod", "data", "model")) if shape else None
    step, _, state_sh, batch_fn = T.make_train_step(cfg, mesh, opts)
    state = {"params": params0, "opt": init_opt_state(params0),
             "step": jnp.zeros((), jnp.int32)}
    if mesh is not None:
        state = jax.device_put(state, state_sh)
    for i in range(STEPS):
        batch = {k: jnp.asarray(v) for k, v in data.batch(i).items()}
        if mesh is not None:
            batch = jax.device_put(batch, batch_fn(batch))
        state, m = step(state, batch)
        gn = m.pop("grad_norm")
        m["grad_norm"] = gn["norm"]
        for k, v in m.items():
            out[f"{name}/m{i}/{k}"] = np.asarray(v)
        for k, v in flat(gn["grads"]).items():
            out[f"{name}/g{i}/{k}"] = v
        if name == "mesh" and i == 0:
            mesh_grads = gn["grads"]
    for k, v in flat(state["params"]).items():
        out[f"{name}/p/{k}"] = v
# the compression alone, on the mesh case's first gradients
mesh = make_mesh(CASES["mesh"][0], ("pod", "data", "model"))
dist = T.make_dist_context(base, mesh)
comp = jax.jit(lambda g: T._compress_pod_grads(g, dist))(mesh_grads)
out.update({f"compressed/{k}": v for k, v in flat(comp).items()})
# the collectives on their own, per rank of the (pod, data) island
from jax.sharding import PartitionSpec as P
from repro.comm.collectives import ef_compressed_psum, psum_bf16
rng = np.random.default_rng(5)
g = rng.normal(size=(4, 6, 5)).astype(np.float32)
err = (rng.normal(size=(4, 6, 5)) * 0.01).astype(np.float32)

def per_rank(gg, ee):
    total, new_err = ef_compressed_psum(gg[0], "pod", ee[0])
    return total[None], new_err[None], psum_bf16(gg[0], "pod")[None]

spec = P(("pod", "data"))
fn = jax.shard_map(per_rank, mesh=mesh, in_specs=(spec, spec),
                   out_specs=(spec, spec, spec), check_vma=False)
for k, v in zip(("total", "error", "bf16"), jax.jit(fn)(g, err)):
    out[f"coll/{k}"] = np.asarray(v)
out["coll/g"], out["coll/err"] = g, err
np.savez(OUT, **out)
print("JAX_SIDE_OK")
"""


@pytest.fixture(scope="module")
def ref(tmp_path_factory):
    """Every case's reference run, in one subprocess on 4 fake devices."""
    path = os.path.join(tmp_path_factory.mktemp("train"), "ref.npz")
    out = run_subprocess(
        f"ARCH = {ARCH!r}\nBATCH, SEQ, STEPS = {BATCH}, {SEQ}, {STEPS}\n"
        f"CASES = {CASES!r}\nOPTIONS = {OPTIONS!r}\nOUT = {path!r}\n"
        + _JAX_SIDE, n_devices=4)
    assert "JAX_SIDE_OK" in out
    return dict(np.load(path))


def _tree(ref, prefix):
    return {k[len(prefix):]: v for k, v in ref.items()
            if k.startswith(prefix)}


def _unflatten(flat):
    """``blocks.0.attn.wq``-keyed arrays as the nested pytree
    ``from_jax_params`` takes (blocks as a list)."""
    tree = {}
    for key, v in flat.items():
        parts = key.split(".")
        node = tree
        for p in parts[:-1]:
            node = node.setdefault(p, {})
        node[parts[-1]] = v
    tree["blocks"] = [tree["blocks"][str(i)]
                      for i in range(len(tree["blocks"]))]
    return tree


def _port_run(ref, case, monkeypatch, use_kernel=True, **cfg_over):
    """The port's STEPS steps of ``case`` (with ``cfg_over`` on its config):
    its metrics, the gradients each step hands to AdamW, and the parameters
    after the last step."""
    shape, over, opt_over = CASES[case]
    cfg = dataclasses.replace(smoke_config(ARCH), compute_dtype="float32",
                              **{**over, **cfg_over})
    params = from_jax_params(_unflatten(_tree(ref, "init/")), cfg,
                             device="cpu", train=True)
    mesh = make_mesh(shape, ("pod", "data", "model"), device="cpu") \
        if shape else None
    opts = pt_train.TrainOptions(**OPTIONS, **opt_over)
    seen = []
    real = pt_train.adamw_update

    def spy(grads, *args):
        seen.append({k: g.detach().clone() for k, g in grads.items()})
        return real(grads, *args)

    monkeypatch.setattr(pt_train, "adamw_update", spy)
    step = pt_train.make_train_step(cfg, mesh, opts, use_kernel=use_kernel,
                                    device="cpu")
    state = pt_train.init_train_state(params)
    data = SyntheticLM(DataConfig(vocab=cfg.vocab, seq_len=SEQ,
                                  global_batch=BATCH), cfg)
    metrics = []
    for i in range(STEPS):
        state, m = step(state, data.batch(i))
        metrics.append({k: float(v) for k, v in m.items()})
    assert int(state["step"]) == STEPS
    final = {k: p.detach().clone() for k, p in params.named_parameters()}
    return metrics, seen, final


def _one_quantum_flips(g, w, pre):
    """Elements where a compressed gradient ``g`` differs from the
    reference's ``w`` by one quantum of the uncompressed ``pre``."""
    quantum = np.abs(pre).max() / 127.0
    diff = np.abs(g - w)
    flips = diff > 0.5 * quantum
    assert np.all(np.abs(diff[flips] - quantum) <= 1e-2 * quantum)
    return flips


def _check_against_ref(ref, case, run):
    metrics, grads, final = run
    flipped = {}
    for i in range(STEPS):
        for k in METRICS:
            want = float(ref[f"{case}/m{i}/{k}"])
            got = metrics[i][k]
            assert abs(got - want) <= 1e-5 * max(abs(want), 1e-6), \
                (case, i, k, got, want)
        want = _tree(ref, f"{case}/g{i}/")
        assert set(grads[i]) == set(want)
        n_flips = 0
        for k, g in grads[i].items():
            g, w = g.numpy(), want[k].astype(np.float32)
            if case == "gc":
                flips = _one_quantum_flips(g, w, ref[f"mesh/g{i}/{k}"])
                n_flips += int(flips.sum())
                flipped[k] = flipped.get(k, False) | flips
                g, w = g[~flips], w[~flips]
            err = np.linalg.norm(g - w) / (np.linalg.norm(w) + 1e-12)
            assert err < 1e-4, (case, i, k, err)
        assert n_flips <= 10, (case, i, n_flips)
    for k, p in final.items():
        p, w = p.numpy(), ref[f"{case}/p/{k}"].astype(np.float32)
        if k in flipped:
            f = flipped[k]
            assert np.all(np.abs(p[f] - w[f]) <= 4 * OPTIONS["peak_lr"])
            p, w = p[~f], w[~f]
        err = np.abs(p - w).max() / np.abs(w).max()
        assert err < 1e-5, (case, k, err)


@pytest.mark.parametrize("case", list(CASES))
def test_train_step_matches_reference(ref, case, monkeypatch):
    _check_against_ref(ref, case, _port_run(ref, case, monkeypatch))


def test_grad_compression_matches_reference(ref):
    """The port's int8 compression over the pod axis of the reference's
    own (uncompressed) gradients gives the reference's integer levels, and
    values within a relative 1e-6 (XLA folds the division by 127 into a
    multiplication, which moves the scale by an ulp)."""
    cfg = dataclasses.replace(smoke_config(ARCH), compute_dtype="float32")
    mesh = make_mesh(CASES["mesh"][0], ("pod", "data", "model"),
                     device="cpu")
    dist = pt_train.make_dist_context(cfg, mesh)
    grads = {k: torch.from_numpy(v)
             for k, v in _tree(ref, "mesh/g0/").items()}
    got = pt_train._compress_pod_grads(grads, dist)
    want = _tree(ref, "compressed/")
    assert set(got) == set(want)
    for k, g in got.items():
        quantum = np.abs(grads[k].numpy()).max() / 127.0
        g, w = g.numpy(), want[k]
        assert np.array_equal(np.round(g / quantum), np.round(w / quantum)), k
        assert np.abs(g - w).max() <= 1e-6 * np.abs(w).max(), k


def test_collectives_match_reference(ref):
    """``ef_compressed_psum`` with an error carry and ``psum_bf16`` over
    ``pod`` of per-rank values on the stacked (pod, data) mesh, against the
    reference under ``shard_map``: the sum and the new carry within 1e-6 of
    the largest value they are taken from (the carried gradient; the scale
    differs by an ulp), the bf16 sum exact; ``tree_ef_state`` is the zero
    carry."""
    from repro_torch.comm.collectives import (ef_compressed_psum, psum_bf16,
                                              tree_ef_state)
    mesh = make_mesh((2, 2), ("pod", "data"), device="cpu")
    g, err = torch.from_numpy(ref["coll/g"]), torch.from_numpy(ref["coll/err"])
    total, new_err = ef_compressed_psum(mesh, g, "pod", err)
    scale = (g + err).abs().max().item()
    for got, key in ((total, "total"), (new_err, "error")):
        assert np.abs(got.numpy() - ref[f"coll/{key}"]).max() <= 1e-6 * scale
    assert np.array_equal(psum_bf16(mesh, g, "pod").numpy(), ref["coll/bf16"])
    zero = tree_ef_state({"a": g})
    assert set(zero) == {"a"} and not zero["a"].any()


def test_plain_versions_match_reference(ref, monkeypatch):
    """use_kernel=False (every plain version) on the mesh."""
    _check_against_ref(ref, "mesh",
                       _port_run(ref, "mesh", monkeypatch, use_kernel=False))


@pytest.mark.parametrize("other", [dict(remat=False),
                                   dict(remat_group=2)])
def test_remat_does_not_change_the_step(ref, monkeypatch, other):
    """remat off, and two-level remat (a group of 2 layers checkpointed
    around its checkpointed layers), give the flat remat's step bit for
    bit."""
    on = _port_run(ref, "mesh", monkeypatch)
    off = _port_run(ref, "mesh", monkeypatch, **other)
    assert on[0] == off[0]
    for a, b in zip(on[1], off[1]):
        assert all(torch.equal(a[k], b[k]) for k in a)
    assert all(torch.equal(on[2][k], off[2][k]) for k in on[2])


def test_grads_reach_every_parameter(ref, monkeypatch):
    """No parameter's gradient is cut: each is nonzero somewhere (the expert
    stacks and everything upstream of attention included)."""
    _, grads, _ = _port_run(ref, "mesh", monkeypatch)
    for k, g in grads[1].items():
        assert g.abs().max() > 0, k
