"""FSDP (ZeRO-3) on one process per rank: every weight of two or more dims
stored over the intra-pod DP axes on its first free dim they divide (the
reference's ``param_shardings`` rule, applied to each layer's own leaf:
``shardings.module_specs``), gathered at the start of each block, of the
embedding and of the head (``models/fsdp.py``), its gradient
reduce-scattered by the gather's backward.

* ``module_specs`` under FSDP equals, leaf by leaf, the reference's
  ``param_specs`` of the unscanned config, for every registered arch at
  its published widths (a scanned stack's layer axis never sharded), and
  each process holds about ``1 / D`` of the weights;
* megatron-moe-32e at smoke size (one layer) in f32, two AdamW steps on
  gloo CPU processes against the reference's ``make_train_step`` with the
  same knobs on 4 fake devices, at ``test_torch_train.py``'s tolerances:
  FSDP on (1, 2, 1) (through the ``Trainer``), FSDP with
  ``seq_shard_activations`` on (1, 2, 2), ``pure_dp`` with FSDP on
  (1, 2, 2) (the batch over the DP axes alone, each model peer running
  the same rows);
* the moments have the shards' shapes; ``global_norm`` over the shards
  equals the norm of the gathered gradients;
* the (1, 2, 1) checkpoint restores bit for bit with no mesh, on the FSDP
  mesh and on the same mesh without FSDP;
* serving with FSDP gives the same bits as serving without it (and with
  SP, as the TP run without either knob);
* every family (the smoke llama3.2-1b, megatron-moe-32e, internvl2-1b,
  whisper-tiny, xlstm-125m and hymba-1.5b, one layer, two for xlstm) on
  (1, 2, 1): served with FSDP bit for bit as without it, one training step
  within ``test_torch_train.py``'s tolerances of it.

One ``train_procs`` spawn a case and one spawn for the families; the
reference runs once, in one subprocess on 4 fake devices.
"""

import dataclasses
import functools

import numpy as np
import pytest
import torch
from conftest import run_subprocess
from test_torch_tp_train import _gather
from test_torch_train import OPTIONS, _check_against_ref, _tree, \
    _unflatten

from repro_torch.checkpoint import restore_checkpoint
from repro_torch.configs import get_config, list_archs, smoke_config
from repro_torch.convert import from_jax_params, recast, shard_module
from repro_torch.data import DataConfig
from repro_torch.launch import serve
from repro_torch.launch import shardings as S
from repro_torch.launch import train as pt_train
from repro_torch.launch.mesh import make_mesh
from repro_torch.models import build_model
from repro_torch.optim import global_norm

AXES = ("pod", "data", "model")
ARCH = "megatron-moe-32e"
BATCH, SEQ = 8, 8
PROMPT, GEN = 8, 3
CASES = {"fsdp": ((1, 2, 1), {"fsdp": True}),
         "fsdp_sp": ((1, 2, 2), {"fsdp": True,
                                 "seq_shard_activations": True}),
         "pure_dp_fsdp": ((1, 2, 2), {"pure_dp": True, "fsdp": True})}
CKPT_CASE = "fsdp"

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

out = {}
params0 = None
for name, (shape, over) in CASES.items():
    cfg = dataclasses.replace(smoke_config(ARCH), compute_dtype="float32",
                              n_layers=1, **over)
    if params0 is None:
        params0 = build_model(cfg).init(jax.random.PRNGKey(0))
        out.update({f"init/{k}": v for k, v in flat(params0).items()})
    data = SyntheticLM(DataConfig(vocab=cfg.vocab, seq_len=SEQ,
                                  global_batch=BATCH), cfg)
    mesh = make_mesh(shape, ("pod", "data", "model"))
    step, _, state_sh, batch_fn = T.make_train_step(
        cfg, mesh, T.TrainOptions(**OPTIONS))
    state = jax.device_put({"params": params0,
                            "opt": init_opt_state(params0),
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


@pytest.fixture(scope="module")
def ref(tmp_path_factory):
    from test_torch_train import STEPS

    path = str(tmp_path_factory.mktemp("fsdp") / "ref.npz")
    code = (f"CASES = {CASES!r}\nARCH = {ARCH!r}\nBATCH, SEQ, STEPS = "
            f"{BATCH}, {SEQ}, {STEPS}\nOPTIONS = {OPTIONS!r}\n"
            f"OUT = {path!r}\n" + _JAX_SIDE)
    assert "JAX_SIDE_OK" in run_subprocess(code, n_devices=4)
    return dict(np.load(path))


def _cfg(name=None, **over):
    knobs = CASES[name][1] if name else {}
    return dataclasses.replace(smoke_config(ARCH), compute_dtype="float32",
                               n_layers=1, **{**knobs, **over})


# -- the specs ----------------------------------------------------------------

@pytest.mark.parametrize("arch", list_archs())
def test_module_specs_are_the_unscanned_param_specs(arch):
    """Per layer, the reference's rule on each layer's own leaf: its
    ``param_specs`` with ``scan_layers=False``, leaf by leaf; no spec of a
    stacked config's per-layer leaf needs a layer axis.  Two layers of
    each (every leaf kind of each arch)."""
    cfg = get_config(arch)
    cfg = dataclasses.replace(cfg, fsdp=True, n_layers=2, block_pattern=(
        cfg.block_pattern[:2] if cfg.block_pattern else None))
    mesh = make_mesh((2, 2, 2), AXES, device="cpu")
    module = build_model(cfg, "meta").init(torch.Generator())
    got = S.module_specs(cfg, mesh, module)
    flat_cfg = dataclasses.replace(cfg, scan_layers=False)
    want = S.flatten_with_path(S.param_specs(
        flat_cfg, mesh, S.param_tree(module, flat_cfg)))
    assert set(got) == {k for k, _ in module.named_parameters()}
    for name, spec in got.items():
        path = tuple(int(p) if p.isdigit() else p for p in name.split("."))
        assert spec == want[path], name
    # every leaf of two or more dims that FSDP can cut is cut over data
    layout = S.fsdp_layout(cfg, mesh)
    assert layout
    for name, (dim, axes) in layout.items():
        assert axes == ("data",) and got[name][dim] == "data", name


def test_fsdp_shard_holds_a_data_share_of_the_weights():
    """A (1, 2, 1) process holds half of each leaf FSDP cuts, the whole of
    the rest: about half the model's bytes."""
    cfg = _cfg("fsdp")
    mesh = make_mesh((1, 2, 1), AXES, device="cpu")
    module = build_model(cfg, "meta", train=True).init(torch.Generator())
    specs = S.module_specs(cfg, mesh, module)
    layout = S.fsdp_layout(cfg, mesh)
    whole = own = 0
    for name, t in module.named_parameters():
        shard = S.shard_tensor(t, specs[name], mesh, (0, 0, 0))
        whole += t.numel()
        own += shard.numel()
        if name in layout:
            assert shard.numel() * 2 == t.numel(), name
        elif t.dim() >= 2:   # the expert stacks: EP already holds "data"
            assert "data" in str(specs[name]) or t.shape[0] % 2, name
    assert own < 0.6 * whole


# -- training, serving and checkpoints on the processes ---------------------------

def _serve_logits(mesh, cfg, whole, prompts):
    """Rank 0's gathered prompt-pass and greedy-step logits of ``whole``
    served on ``mesh`` under ``cfg``."""
    specs = S.batch_specs(mesh, {"tokens": prompts},
                          pure_dp=cfg.pure_dp and not cfg.fsdp)
    rows = S.shard_tensor(prompts, specs["tokens"], mesh)
    shard = recast(shard_module(whole, cfg, mesh), cfg)
    got = serve._greedy(mesh, cfg, shard, rows, specs["tokens"], None, None,
                        GEN)
    return got.get("logits")


def _hook(mesh, cfg, shards, train, *, ckpt, prompts):
    """Train (reading each step's gradients, the optimizer's moments and
    the norm over the shards where AdamW gets them); gather the run on
    rank 0; serve the trained weights with the case's knobs and without
    FSDP (and SP); restore the checkpoint on this mesh with and without
    FSDP."""
    from repro_torch.launch.shardings import gather_tensor

    specs = pt_train.train_specs(cfg, mesh)
    module, seen, moments, norms, metrics = shards[0], [], [], [], []
    real = pt_train.adamw_update

    def spy(grads, state, *args):
        seen.append({k: g.detach().clone() for k, g in grads.items()})
        moments.append({k: (tuple(state.m[k].shape),
                            tuple(state.v[k].shape)) for k in state.m})
        norms.append(float(global_norm(grads, mesh, specs)))
        return real(grads, state, *args)

    def each_step(i, run):
        state, m = run()
        metrics.append({k: float(v) for k, v in m.items()})
        return state, m

    pt_train.adamw_update = spy
    try:
        res = train(each_step)
    finally:
        pt_train.adamw_update = real
    own = {k: v.detach().clone() for k, v in module.named_parameters()}
    whole = {k: gather_tensor(v, specs[k], mesh) for k, v in own.items()}
    out = {"coords": mesh.rank_coords, "norms": norms,
           "moments": moments[0],
           "shapes": {k: tuple(v.shape) for k, v in own.items()},
           "run": (metrics, [_gather(mesh, specs, g) for g in seen],
                   whole if mesh.rank == 0 else None)}
    plain = dataclasses.replace(cfg, fsdp=False, seq_shard_activations=False)
    out["served"] = _serve_logits(mesh, dataclasses.replace(
        cfg, compute_dtype="float32"), whole, prompts)
    out["served_plain"] = _serve_logits(mesh, plain, whole, prompts)
    if ckpt:
        restored = {}
        for key, c in (("fsdp", cfg), ("plain", plain)):
            target_specs = pt_train.train_specs(c, mesh)
            target = pt_train.init_train_state(recast(
                {k: torch.zeros_like(S.shard_tensor(v, target_specs[k],
                                                    mesh))
                 for k, v in whole.items()}, c, train=True))
            _, step = restore_checkpoint(ckpt, target, mesh=mesh,
                                         specs=target_specs)
            restored[key] = (step, all(
                torch.equal(p, S.shard_tensor(whole[k], target_specs[k],
                                              mesh))
                for k, p in target["params"].named_parameters()))
        out["restored"] = restored
        out["trainer"] = {k: res[k] for k in ("stopped_at", "preempted")}
    return out


@pytest.fixture(scope="module")
def procs(ref, tmp_path_factory):
    from test_torch_train import STEPS

    out = {}
    prompts = torch.from_numpy(np.random.default_rng(5).integers(
        0, _cfg().vocab, (BATCH, PROMPT)))
    for name, (shape, _) in CASES.items():
        cfg = _cfg(name)
        rdv = tmp_path_factory.mktemp(f"rdv_{name}") / "store"
        ckpt = str(tmp_path_factory.mktemp("ckpt")) if name == CKPT_CASE \
            else None
        module = from_jax_params(_unflatten(_tree(ref, "init/")), cfg,
                                 device="cpu", train=True)
        res = pt_train.train_procs(
            cfg, [module], DataConfig(vocab=cfg.vocab, seq_len=SEQ,
                                      global_batch=BATCH),
            shape, "gloo", "cpu", pt_train.TrainOptions(**OPTIONS), STEPS,
            ckpt_dir=ckpt, hook=functools.partial(_hook, ckpt=ckpt,
                                                  prompts=prompts),
            init_method=f"file://{rdv}", timeout=60.0, join_timeout=240)
        out[name] = {"ranks": res["ranks"], "ckpt": ckpt}
    return out


@pytest.mark.parametrize("name", list(CASES))
def test_processes_train_as_the_reference_with_fsdp(ref, procs, name):
    ranks = procs[name]["ranks"]
    assert len(ranks) == int(np.prod(CASES[name][0]))
    _check_against_ref(ref, name, ranks[0]["run"])


@pytest.mark.parametrize("name", list(CASES))
def test_moments_have_the_shards_shapes(procs, name):
    cfg, shape = _cfg(name), CASES[name][0]
    layout = S.fsdp_layout(cfg, make_mesh(shape, AXES, device="cpu"))
    assert layout
    whole = dict(build_model(cfg, "meta", train=True).init(
        torch.Generator()).named_parameters())
    for rank in procs[name]["ranks"]:
        for k, (m, v) in rank["moments"].items():
            assert m == v == rank["shapes"][k], k
        for k, (dim, axes) in layout.items():
            n = int(np.prod([shape[AXES.index(a)] for a in axes]))
            assert rank["shapes"][k][dim] * n == whole[k].shape[dim], k


@pytest.mark.parametrize("name", list(CASES))
def test_global_norm_over_the_shards_is_the_whole_norm(procs, name):
    _, grads, _ = procs[name]["ranks"][0]["run"]
    for i, g in enumerate(grads):
        want = float(torch.sqrt(sum(torch.sum(t.double() ** 2)
                                    for t in g.values())))
        for rank in procs[name]["ranks"]:
            assert rank["norms"][i] == procs[name]["ranks"][0]["norms"][i]
        assert abs(procs[name]["ranks"][0]["norms"][i] - want) \
            <= 1e-6 * want


@pytest.mark.parametrize("name", list(CASES))
def test_serving_with_fsdp_is_bit_identical_without_it(procs, name):
    """The trained weights served with the case's knobs and with neither
    FSDP nor SP (the same rows: under ``pure_dp`` without FSDP each model
    peer serves a part of its ``(pod, data)`` shard's, the MoE routing
    them together): every step's gathered logits the same bits."""
    r0 = procs[name]["ranks"][0]
    assert len(r0["served"]) == GEN
    for a, b in zip(r0["served"], r0["served_plain"]):
        assert torch.equal(a, b)


def test_checkpoint_restores_bit_for_bit_on_every_mesh(procs):
    """The Trainer's checkpoint of the FSDP run: with no mesh and on the
    stacked ``LocalMesh`` (whole), on the FSDP mesh and on the same mesh
    without FSDP, each restored leaf the trained one."""
    from test_torch_train import STEPS

    ranks = procs[CKPT_CASE]["ranks"]
    final = ranks[0]["run"][2]
    for rank in ranks:
        assert rank["trainer"] == {"stopped_at": STEPS, "preempted": False}
        for key in ("fsdp", "plain"):
            assert rank["restored"][key] == (STEPS, True), key
    cfg = _cfg(CKPT_CASE)
    for mesh in (None, make_mesh(CASES[CKPT_CASE][0], AXES, device="cpu")):
        target = pt_train.init_train_state(recast(
            {k: torch.zeros_like(v) for k, v in final.items()}, cfg,
            train=True))
        _, step = restore_checkpoint(procs[CKPT_CASE]["ckpt"], target,
                                     mesh=mesh)
        assert step == STEPS
        for k, p in target["params"].named_parameters():
            assert torch.equal(p, final[k]), k


# -- every family with FSDP -----------------------------------------------------

FAMILY_SHAPE = (1, 2, 1)


def _family_cfg(arch, fsdp):
    from test_torch_seq_shard import _cfg as seq_cfg

    return dataclasses.replace(seq_cfg(arch, sp=False), fsdp=fsdp)


def _family_inputs(cfg, s):
    rng = np.random.default_rng(7)
    out = {"tokens": rng.integers(0, cfg.vocab, (4, s))}
    if cfg.frontend == "vision_stub":
        out["patch_embeds"] = rng.standard_normal(
            (4, cfg.frontend_len, cfg.d_model)).astype(np.float32)
    if cfg.encdec:
        out["frames"] = rng.standard_normal(
            (4, cfg.encoder_len, cfg.d_model)).astype(np.float32)
    return out


def _family_fsdp_child(mesh, cases):
    """Each family served and trained one step with FSDP and without it on
    this process's rows: the FSDP run's logits and caches, each step's,
    against the other's bit for bit; its metrics, gathered gradients and
    parameters beside the other's (rank 0)."""
    from test_torch_seq_shard import _serve, _tensors, _train, _whole

    out = {}
    for name, (arch, s, serve_whole, train_whole, inp) in cases.items():
        serve_whole, train_whole = _tensors(serve_whole), \
            _tensors(train_whole)
        inp = _tensors(inp)
        runs = {}
        for fsdp in (True, False):
            cfg = _family_cfg(arch, fsdp)
            logits, cache = _serve(mesh, cfg, serve_whole, inp, s)
            m, g, p, specs = _train(mesh, cfg, train_whole)
            runs[fsdp] = (logits, cache, m, _whole(mesh, specs, g),
                          _whole(mesh, specs, p),
                          S.fsdp_layout(cfg, mesh))
        (la, ca, ma, ga, pa, layout), (lb, cb, mb, gb, pb, _) = \
            runs[True], runs[False]
        out[name] = {
            "layout": sorted(layout),
            "logits_equal": all(torch.equal(a, b) for a, b in zip(la, lb)),
            "cache_equal": all(torch.equal(x[k], y[k])
                               for x, y in zip(ca, cb) for k in x),
            "metrics": (ma, mb),
            "grad_err": max(float((ga[k] - gb[k]).norm()
                                  / (gb[k].norm() + 1e-12)) for k in gb),
            "param_err": max(float((pa[k] - pb[k]).abs().max()
                                   / max(float(pb[k].abs().max()), 1.0))
                             for k in pb)}
    return out


@pytest.fixture(scope="module")
def families(tmp_path_factory):
    from test_torch_seq_shard import FAMILIES, S as PROMPT_LEN

    from repro_torch.launch import procs as P

    cases = {}
    for name, arch in FAMILIES.items():
        cfg = _family_cfg(arch, False)
        gen = torch.Generator().manual_seed(3)
        serve_whole = {k: v.detach().numpy() for k, v in build_model(
            cfg, "cpu").init(gen).named_parameters()}
        gen = torch.Generator().manual_seed(3)
        train_whole = {k: v.detach().numpy() for k, v in build_model(
            cfg, "cpu", train=True).init(gen).named_parameters()}
        cases[name] = (arch, PROMPT_LEN, serve_whole, train_whole,
                       _family_inputs(cfg, PROMPT_LEN))
    rdv = tmp_path_factory.mktemp("rdv_fsdp_families") / "store"
    return P.spawn(_family_fsdp_child, FAMILY_SHAPE, AXES, "gloo", "cpu",
                   cases, init_method=f"file://{rdv}", timeout=60.0,
                   join_timeout=300)


@pytest.mark.parametrize("name", ["dense", "moe", "vlm", "encdec", "ssm",
                                  "hybrid"])
def test_every_family_serves_and_trains_with_fsdp(families, name):
    """FSDP cuts leaves of every family (a layout is there) and moves bits
    unchanged in serving: the prompt pass's and each decode step's logits
    and the caches bit for bit the run without it; one training step
    within ``test_torch_train.py``'s tolerances of it (the gradients'
    sums run in another order)."""
    for rank in families:
        res = rank[name]
        assert res["layout"]
        assert res["logits_equal"] and res["cache_equal"]
        got, want = res["metrics"]
        for k in ("loss", "nll", "aux", "grad_norm"):
            assert abs(got[k] - want[k]) <= 1e-5 * max(abs(want[k]), 1e-6)
    r0 = families[0][name]
    assert r0["grad_err"] < 1e-4
    assert r0["param_err"] < 1e-5
