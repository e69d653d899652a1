"""``pure_dp`` on one process per rank: the reference's knob for small
models, weights replicated on every process and the batch cut over every
mesh axis, "model" included.  Smoke archs in f32 on gloo CPU processes
against the reference's ``make_train_step`` and serving with
``pure_dp=True`` on 4 fake devices, and against the port's stacked
``LocalMesh`` run of the same DP shape:

* llama3.2-1b on (1, 2, 2): dense, the tied embedding whole;
* megatron-moe-32e on (1, 2, 2) and (2, 1, 2): the island over
  ``(pod, data)``, each shard's model peers' rows routed together as the
  reference's ``shard_map`` over the DP axes hands them.

Checked: the prompt pass's and each decode step's logits within a
relative 1e-5 of both, greedy tokens equal; each process's MoE dispatch
buffer and token grid (``moe._dispatch``, ``moe._expert_ffn``) bit for bit
its ``(pod, data)`` shard's in the stacked run and the same on its model
peers; two AdamW steps at ``test_torch_train.py``'s tolerances against the
reference, the metrics and final parameters within 1e-5 of the stacked
step's, every gradient bit for bit the same on model peers; a planted
fault (``_sync_grads`` skipping "model") fails the check against the
reference.  One spawn a mesh serves and trains; the reference runs once,
in one subprocess on 4 fake devices.
"""

import dataclasses
import functools

import numpy as np
import pytest
import torch
from conftest import run_subprocess
from test_torch_tp_head_cut import _nest
from test_torch_tp_serve import _by_coords, _rel
from test_torch_tp_train import _hook as _train_hook
from test_torch_train import OPTIONS, STEPS as TRAIN_STEPS, \
    _check_against_ref, _tree

from repro_torch.configs import smoke_config
from repro_torch.convert import from_jax_params
from repro_torch.data import DataConfig, SyntheticLM
from repro_torch.launch import serve
from repro_torch.launch import train as pt_train
from repro_torch.launch.mesh import make_mesh
from repro_torch.models import moe

AXES = ("pod", "data", "model")
B, S, STEPS = 8, 8, 3
CASES = {"llama": ("llama3.2-1b", (1, 2, 2)),
         "megatron": ("megatron-moe-32e", (1, 2, 2)),
         "megatron_pod": ("megatron-moe-32e", (2, 1, 2))}
MOE_CASES = ("megatron", "megatron_pod")
TRAIN_BATCH, TRAIN_SEQ = 8, 16
FAULT_CASE = "megatron"

_JAX_SIDE = """
import dataclasses
import numpy as np, jax, jax.numpy as jnp
from repro.configs import smoke_config
from repro.data import DataConfig, SyntheticLM
from repro.launch import train as T
from repro.launch.mesh import make_mesh
from repro.launch.serve import make_serve_step
from repro.launch.shardings import batch_shardings, param_shardings
from repro.launch.train import make_dist_context, make_rules
from repro.models import build_model, use_mesh_rules
from repro.models.transformer import lm_prefill
from repro.optim import init_opt_state

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

real_update = T.adamw_update

def spy(grads, opt, params, lr, cfg):
    p, o, n = real_update(grads, opt, params, lr, cfg)
    return p, o, {"norm": n, "grads": grads}

out = {}
for name, (arch, shape) in CASES.items():
    cfg = dataclasses.replace(smoke_config(arch), compute_dtype="float32",
                              pure_dp=True)
    params = build_model(cfg).init(jax.random.PRNGKey(1))
    out.update({f"{name}/p/{k}": v for k, v in flat(params).items()})
    prompts = np.random.default_rng(3).integers(0, cfg.vocab, (B, S))
    out[f"{name}/prompts"] = prompts
    mesh = make_mesh(shape, ("pod", "data", "model"))
    params = jax.device_put(params, param_shardings(
        cfg, mesh, jax.eval_shape(lambda: params)))
    toks_in = jax.device_put(jnp.asarray(prompts), batch_shardings(
        mesh, jax.ShapeDtypeStruct((B, S), jnp.int32), pure_dp=True))
    dist = make_dist_context(cfg, mesh, None)
    step = make_serve_step(cfg, mesh, None)
    with use_mesh_rules(make_rules(cfg, mesh)):
        logits, cache = jax.jit(lambda p, t: lm_prefill(
            cfg, p, t, None, dist, cache_len=S + STEPS))(params, toks_in)
    out[f"{name}/logits0"] = np.asarray(logits)
    toks = jnp.argmax(logits, -1)
    for i, t in enumerate(range(S, S + STEPS)):
        logits, cache = step(params, cache, toks, jnp.int32(t))
        out[f"{name}/logits{i + 1}"] = np.asarray(logits)
        toks = jnp.argmax(logits, -1)

    T.adamw_update = spy   # the step reads its gradients out via grad_norm
    params0 = build_model(cfg).init(jax.random.PRNGKey(0))
    out.update({f"train_{name}/init/{k}": v
                for k, v in flat(params0).items()})
    data = SyntheticLM(DataConfig(vocab=cfg.vocab, seq_len=TRAIN_SEQ,
                                  global_batch=TRAIN_BATCH), cfg)
    tstep, _, state_sh, batch_fn = T.make_train_step(
        cfg, mesh, T.TrainOptions(**OPTIONS))
    state = jax.device_put({"params": params0,
                            "opt": init_opt_state(params0),
                            "step": jnp.zeros((), jnp.int32)}, state_sh)
    for i in range(TRAIN_STEPS):
        batch = {k: jnp.asarray(v) for k, v in data.batch(i).items()}
        state, m = tstep(state, jax.device_put(batch, batch_fn(batch)))
        gn = m.pop("grad_norm")
        m["grad_norm"] = gn["norm"]
        for k, v in m.items():
            out[f"train_{name}/m{i}/{k}"] = np.asarray(v)
        for k, v in flat(gn["grads"]).items():
            out[f"train_{name}/g{i}/{k}"] = v
    for k, v in flat(state["params"]).items():
        out[f"train_{name}/p/{k}"] = v
    T.adamw_update = real_update
np.savez(OUT, **out)
print("JAX_SIDE_OK")
"""


@pytest.fixture(scope="module")
def ref(tmp_path_factory):
    path = str(tmp_path_factory.mktemp("pure_dp") / "ref.npz")
    code = (f"CASES = {CASES!r}\nB, S, STEPS = {B}, {S}, {STEPS}\n"
            f"TRAIN_BATCH, TRAIN_SEQ, TRAIN_STEPS = {TRAIN_BATCH}, "
            f"{TRAIN_SEQ}, {TRAIN_STEPS}\n"
            f"OPTIONS = {OPTIONS!r}\nOUT = {path!r}\n" + _JAX_SIDE)
    assert "JAX_SIDE_OK" in run_subprocess(code, n_devices=4)
    return dict(np.load(path))


def _cfg(name):
    return dataclasses.replace(smoke_config(CASES[name][0]),
                               compute_dtype="float32", pure_dp=True)


def _module(ref, name, prefix=None, train=False):
    return from_jax_params(_nest(_tree(ref, prefix or f"{name}/p/")),
                           _cfg(name), device="cpu", train=train)


def _data_cfg(cfg):
    return DataConfig(vocab=cfg.vocab, seq_len=TRAIN_SEQ,
                      global_batch=TRAIN_BATCH)


class _MoESpy:
    """While active, keeps every dispatch buffer (``moe._dispatch``) and
    token grid (``moe._expert_ffn``) of the MoE layers."""

    def __enter__(self):
        self.dispatch, self.ffn = moe._dispatch, moe._expert_ffn
        self.bufs, self.grids = [], []

        def dispatch(*args):
            got = self.dispatch(*args)
            self.bufs.append(got[0].detach().numpy().copy())
            return got

        def ffn(cfg, w_gate, w_up, w_down, tokens, *args, **kw):
            self.grids.append(tokens.detach().numpy().copy())
            return self.ffn(cfg, w_gate, w_up, w_down, tokens, *args, **kw)

        moe._dispatch, moe._expert_ffn = dispatch, ffn
        return self

    def __exit__(self, *exc):
        moe._dispatch, moe._expert_ffn = self.dispatch, self.ffn


class _SkipModel:
    """While active, ``_sync_grads`` sums over the DP axes alone, skipping
    "model": the planted fault."""

    def __enter__(self):
        self.real = real = pt_train._sync_grads

        def skip(grads, mesh, specs, axes=None):
            return real(grads, mesh, specs,
                        tuple(a for a in axes if a != "model"))
        pt_train._sync_grads = skip
        return self

    def __exit__(self, *exc):
        pt_train._sync_grads = self.real


def _train(mesh, cfg, params):
    return pt_train._train_rank(
        mesh, cfg, [dict(params)], _data_cfg(cfg),
        pt_train.TrainOptions(**OPTIONS), TRAIN_STEPS, True, None,
        hook=_train_hook)["hook"]


def _hook(mesh, cfg, shards, rows, serve_rows, *, name, train_params):
    """``serve_procs``' own serve; then a prompt pass recording the MoE's
    dispatch buffers and grids; then two training steps on the
    reference's initial parameters, and for ``FAULT_CASE`` two more under
    the planted fault."""
    serve_rows()
    out = {"coords": mesh.rank_coords}
    with torch.no_grad(), _MoESpy() as spy:
        serve.make_prefill_step(cfg, mesh, cache_len=S + STEPS)(
            shards.pop(), {"tokens": rows})
    out.update(bufs=spy.bufs, grids=spy.grids)
    out["train"] = _train(mesh, cfg, train_params)
    if name == FAULT_CASE:
        with _SkipModel():
            out["fault"] = _train(mesh, cfg, train_params)
    return out


@pytest.fixture(scope="module")
def procs(ref, tmp_path_factory):
    res = {}
    for name, (_, shape) in CASES.items():
        rdv = tmp_path_factory.mktemp(f"rdv_{name}") / "store"
        train_params = {k: v.detach() for k, v in _module(
            ref, name, f"train_{name}/init/", train=True)
            .named_parameters()}
        res[name] = serve.serve_procs(
            _cfg(name), [_module(ref, name)],
            torch.from_numpy(ref[f"{name}/prompts"]), shape, "gloo", "cpu",
            gen_len=STEPS + 1,
            hook=functools.partial(_hook, name=name,
                                   train_params=train_params),
            init_method=f"file://{rdv}", timeout=60.0, join_timeout=240)
    return res


@pytest.fixture(scope="module")
def local(ref):
    """The stacked LocalMesh run of every case (the DP shape, "model" at
    1): served, its MoE spied on, and trained."""
    out = {}
    for name, (_, shape) in CASES.items():
        cfg = _cfg(name)
        mesh = make_mesh(shape[:2] + (1,), AXES, device="cpu")
        module = _module(ref, name)
        prompts = torch.from_numpy(ref[f"{name}/prompts"])
        step = serve.make_serve_step(cfg, mesh, device="cpu")
        with torch.no_grad(), _MoESpy() as spy:
            logits, cache = serve.make_prefill_step(
                cfg, mesh, cache_len=S + STEPS, device="cpu")(
                    module, {"tokens": prompts})
        got, toks = [logits], [logits.argmax(-1)]
        for t in range(S, S + STEPS):
            logits, cache = step(module, cache, toks[-1], t)
            got.append(logits)
            toks.append(logits.argmax(-1))
        state = pt_train.init_train_state(
            _module(ref, name, f"train_{name}/init/", train=True))
        tstep = pt_train.make_train_step(
            cfg, mesh, pt_train.TrainOptions(**OPTIONS), device="cpu")
        data = SyntheticLM(_data_cfg(cfg), cfg)
        metrics = []
        for i in range(TRAIN_STEPS):
            state, m = tstep(state, data.batch(i))
            metrics.append({k: float(v) for k, v in m.items()})
        out[name] = {"logits": got, "tokens": torch.stack(toks, 1),
                     "bufs": spy.bufs, "grids": spy.grids,
                     "metrics": metrics,
                     "params": {k: v.detach().numpy() for k, v in
                                state["params"].named_parameters()}}
    return out


@pytest.mark.parametrize("step", range(STEPS + 1))
@pytest.mark.parametrize("name", list(CASES))
def test_logits_match_reference_and_local_mesh(ref, procs, local, name,
                                               step):
    got = procs[name]["logits"][step].numpy()
    assert got.shape == (B, _cfg(name).vocab)
    assert _rel(got, ref[f"{name}/logits{step}"]) < 1e-5
    assert _rel(got, local[name]["logits"][step].numpy()) < 1e-5


@pytest.mark.parametrize("name", list(CASES))
def test_greedy_tokens_equal(ref, procs, local, name):
    got = procs[name]["tokens"]
    assert torch.equal(got, local[name]["tokens"])
    want = np.stack([ref[f"{name}/logits{i}"].argmax(-1)
                     for i in range(STEPS + 1)], 1)
    assert np.array_equal(got.numpy(), want)


@pytest.mark.parametrize("name", MOE_CASES)
def test_moe_shard_dispatch_and_grid_are_the_stacked_shards(procs, local,
                                                            name):
    """The island routes a ``(pod, data)`` shard's rows, its model peers'
    together: each process's dispatch buffer and token grid are its
    shard's in the stacked run (rank ``r`` of ``[R, E * C, d]`` and of
    ``[R * E_loc, G * C, d]``), bit for bit, every model peer alike."""
    cfg, shape = _cfg(name), CASES[name][1]
    n_dp = shape[0] * shape[1]
    e_loc = cfg.moe.num_experts // n_dp
    want = local[name]
    assert len(want["grids"]) == cfg.n_layers
    for r in procs[name]["ranks"]:
        dp = r["coords"][0] * shape[1] + r["coords"][1]
        assert len(r["grids"]) == len(r["bufs"]) == cfg.n_layers
        for got, w in zip(r["bufs"], want["bufs"]):
            assert got.shape[0] == 1
            assert np.array_equal(got[0], w[dp])
        for got, w in zip(r["grids"], want["grids"]):
            assert np.array_equal(got, w[dp * e_loc:(dp + 1) * e_loc])


@pytest.mark.parametrize("name", list(CASES))
def test_processes_train_as_the_reference_and_local_mesh(ref, procs, local,
                                                         name):
    ranks = [r["train"] for r in procs[name]["ranks"]]
    assert len(ranks) == int(np.prod(CASES[name][1]))
    # weights whole: no leaf is sharded over "model"
    assert ranks[0]["sharded"] == []
    _check_against_ref(ref, f"train_{name}", ranks[0]["run"])
    metrics, _, final = ranks[0]["run"]
    for got, want in zip(metrics, local[name]["metrics"]):
        for k in ("loss", "nll", "aux", "grad_norm"):
            assert abs(got[k] - want[k]) <= 1e-5 * max(abs(want[k]), 1e-6)
    for k, w in local[name]["params"].items():
        assert np.abs(final[k].numpy() - w).max() <= 1e-5 * np.abs(w).max()


@pytest.mark.parametrize("name", list(CASES))
def test_gradients_identical_on_model_peers(procs, name):
    shape = CASES[name][1]
    by = _by_coords([r["train"] for r in procs[name]["ranks"]])
    for pod in range(shape[0]):
        for data in range(shape[1]):
            first = by[(pod, data, 0)]["replicated"]
            assert len(first) == TRAIN_STEPS and first[0]
            for m in range(1, shape[2]):
                for a, b in zip(first, by[(pod, data, m)]["replicated"]):
                    assert set(a) == set(b)
                    for k in a:
                        assert np.array_equal(a[k], b[k]), k


def test_sync_skipping_model_fails_the_check(ref, procs):
    """The planted fault (``_SkipModel``) moves the gradients off the
    reference's: each process keeps the mean over its own "model"
    coordinate's rows."""
    run = procs[FAULT_CASE]["ranks"][0]["fault"]["run"]
    with pytest.raises(AssertionError):
        _check_against_ref(ref, f"train_{FAULT_CASE}", run)
